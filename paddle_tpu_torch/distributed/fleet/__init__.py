"""Fleet (counterpart of ``paddle_tpu/distributed/fleet``): the
model-parallel ops only, so far."""
