"""Distributed pieces of the port (counterpart of
``paddle_tpu/distributed``): so far only the tensor-parallel reduction the
serving engine's decode chain uses (:mod:`.fleet.layers.mpu.mp_ops`). The
runtime on ``torch.distributed`` is a later slice."""
