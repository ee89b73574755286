from posendf_torch.utils.profiling import StepTimer, enable_nan_debugging, trace

__all__ = ["trace", "StepTimer", "enable_nan_debugging"]
