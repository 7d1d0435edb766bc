"""repro_torch.core — Algorithm 2 (truncated mini-batch kernel k-means)
over torch tensors: kernels, center state, rates, init, the step and the
fit-loop core.  The front door is ``repro_torch.api.KernelKMeans``."""
