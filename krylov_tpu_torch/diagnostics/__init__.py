from krylov_tpu_torch.diagnostics.report import build_info, finish_banner, start_banner

__all__ = ["build_info", "finish_banner", "start_banner"]
