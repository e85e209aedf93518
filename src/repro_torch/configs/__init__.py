"""Architecture registry of the port: gemma2-2b only (the dense family is
the first slice; the other nine specs of `repro.configs` are still to port)."""
from .common import ArchSpec, CodingPlan, ShapeCfg  # noqa: F401
from .gemma2_2b import ARCH as _GEMMA2_2B

REGISTRY = {_GEMMA2_2B.arch_id: _GEMMA2_2B}
