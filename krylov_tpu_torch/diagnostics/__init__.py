from krylov_tpu_torch.diagnostics.report import build_info, finish_banner, start_banner
from krylov_tpu_torch.diagnostics import profiling

__all__ = ["build_info", "finish_banner", "start_banner", "profiling"]
