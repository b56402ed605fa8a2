"""PyTorch/CUDA port of the NFFT fast-summation system (arXiv:1808.04580).

A second package beside the JAX reference ``repro``, with the same module
names: ``core`` (kernels, regularization, NFFT plan, fused execution,
fastsum operators and the exact direct sum, Lanczos, CG/MINRES, the
Lemma 3.1 error bound), ``kernels`` (hand-written CUDA kernels for Hopper
and their plain PyTorch versions), ``graph`` (spectral clustering, kernel
SSL, kernel ridge regression), ``runtime`` (accuracy guards), ``data``
(synthetic point sets and the LM data pipeline), and the LM framework:
``configs`` (architectures), ``models`` (dense GQA and NFFT attention
blocks: training forward, prefill and decode), ``serving`` (the
continuous-batching engine), ``training`` (optimizers, the train step,
checkpoints, the fault-tolerant loop), ``dist`` (error-feedback gradient
compression) and ``launch`` (the command lines).  Entry points run on the CUDA card unless the caller asks for
``device="cpu"``.
"""

from repro_torch.device import init_cpu_math as _init_cpu_math

_init_cpu_math()
