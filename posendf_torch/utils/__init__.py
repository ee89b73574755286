from posendf_torch.utils.profiling import SETUP_S, enable_nan_debugging, span, trace

__all__ = ["trace", "span", "SETUP_S", "enable_nan_debugging"]
