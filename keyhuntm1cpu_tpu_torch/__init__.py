"""keyhuntm1cpu_tpu_torch — the PyTorch + CUDA port of keyhuntm1cpu_tpu.

The JAX package ``keyhuntm1cpu_tpu`` is the reference; this package
re-implements its BSGS paths (host and device resolve, the five range
orders, bsgsd), the brute-force modes (fused and large-target walker
paths), vanity prefixes, minikeys, resumable checkpoints, the CLI, the
coordinator/worker fleet and the reference file interop for an NVIDIA
Hopper GPU (sm_90a). Module and public function names follow the JAX package so
each counterpart is easy to find:

- ``field.fe``, ``field.pinv``: plain torch mod-p limb arithmetic (CPU
                        version of ``csrc/fe.cuh``), numpy limb helpers and
                        the batched inverse kernel.
- ``curve``           : the BSGS walk (K1/K2), the fused brute kernel (K4),
                        the walker walk and the scalar-mult ladder (K6).
- ``hash``            : SHA-256 / RIPEMD-160 / Keccak tile functions, the
                        batch hash kernels and the minikey kernels.
- ``filter``          : bitmap / bloom2 cascade, the insert (K3) and probe
                        kernels, the sorted target table, the host table.
- ``engine``          : the BSGS, brute-force and minikeys engines, vanity
                        intervals, the stop flag.
- ``convert``         : carries filters and params over from the JAX package.
- ``cli``, ``server`` : ``python -m keyhuntm1cpu_tpu_torch.cli -m bsgs ...``;
                        bsgsd.
- ``dist``            : the coordinator and workers running these engines.
- ``utils``, ``native``: target files and their caches, the reference's
                        .blm / .tbl / .dat files, the native host library.
- ``ref``, ``core``   : copies of the JAX package's exact curve arithmetic,
                        address encoding, logger, key staging buffer,
                        errors, checkpoint files, config and metrics.

The package imports neither jax nor the JAX package. Importing it compiles nothing: ``_build`` builds the CUDA
kernels (nvcc) and the native host library (g++) on first use. Every
wrapper runs its plain torch version for a CPU tensor and launches its
kernel for a CUDA tensor; there is no silent fallback between the two.
"""

__version__ = "0.1.0"
