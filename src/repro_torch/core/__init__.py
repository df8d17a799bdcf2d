from repro_torch.core import costmodel, nanobatch, pipeline  # noqa: F401
