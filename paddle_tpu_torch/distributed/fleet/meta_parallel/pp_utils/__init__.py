"""Pipeline utilities (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pp_utils``)."""

from . import p2p_communication  # noqa: F401
