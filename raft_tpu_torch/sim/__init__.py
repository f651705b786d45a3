"""The batched path: `state.py` (the [G, K] struct of tensors), `step.py`
(the plain tick), `run.py` (the loop and metrics), `kernel.py` (the
fused-chunk CUDA kernel's wrapper, the packed wire's codec and the byte
model)."""
