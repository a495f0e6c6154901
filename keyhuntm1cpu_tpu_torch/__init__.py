"""keyhuntm1cpu_tpu_torch — the PyTorch + CUDA port of keyhuntm1cpu_tpu.

The JAX package ``keyhuntm1cpu_tpu`` is the reference; this package
re-implements its BSGS host-resolve path for an NVIDIA Hopper GPU
(sm_90a). Module and public function names follow the JAX package so
each counterpart is easy to find:

- ``field.fe``        : plain torch mod-p limb arithmetic (CPU version of
                        ``csrc/fe.cuh``) and numpy limb helpers.
- ``curve.pwalk``     : advance chain + walk blocks (CUDA kernels K1/K2).
- ``filter.bitmap``   : bitmap / bloom2 membership cascade and the fused
                        filter-insert kernel K3.
- ``filter.host_table``: the native-built, disk-cached exact baby table.
- ``engine.bsgs``     : the BSGS host-resolve engine.
- ``convert``         : carries filters and params over from the JAX package.
- ``cli``             : ``python -m keyhuntm1cpu_tpu_torch.cli -m bsgs ...``.
- ``ref``, ``core``   : copies of the JAX package's exact curve arithmetic,
                        address encoding, logger and key staging buffer.

The package imports neither jax nor the JAX package. Importing it compiles nothing: ``_build`` builds the CUDA
kernels (nvcc) and the native host library (g++) on first use. Every
wrapper runs its plain torch version for a CPU tensor and launches its
kernel for a CUDA tensor; there is no silent fallback between the two.
"""

__version__ = "0.1.0"
