"""Fleet layers: the model-parallel ops (:mod:`.mpu.mp_ops`)."""
