"""Model-parallel utilities: :mod:`.mp_ops`."""
