"""zukelang_tpu_torch — the PyTorch/CUDA port of zukelang_tpu.

The JAX package (`zukelang_tpu`) stays the reference.  This package runs
Groth16 and Pinocchio (NonZK and ZK) keygen, prove and verify on an
NVIDIA GPU with the Pallas kernels of the reference rewritten as CUDA C++
for sm_90a (`csrc/`), and on the CPU through each kernel's plain PyTorch
version.

Layering (bottom to top), each module named after its JAX counterpart:
  params                   — curve constants, limb-32 Montgomery constants
  golden/, rng, serialize  — host oracle (field, curve, pairing), the
                             scalar streams, keypair JSON helpers
  native, pairing          — the host C++ pairing (hostsrc/), built at use
  build                    — nvcc build of csrc/*.cu, loaded with ctypes
  ops/kernels              — kernel wrappers, plain versions, launch counts
  ops/field, ops/curve     — field and curve arithmetic on limb tensors
  ops/ntt, ops/msm         — NTT, Pippenger and fixed-base MSM
  core/flat                — flattened circuits (numpy packing)
  engine/torch_engine      — witness reduction, keygen evaluation at tau
  protocols/               — device Groth16 and Pinocchio, Pinocchio verify
  vectors                  — the frozen x^3+x+3 vectors (testdata/)
  bench_lib                — synthetic R1CS, the Groth16 and Pinocchio
                             bench runs
  bench_rung, bench        — one bench rung as a process; the bench that
                             runs the rungs and prints JSON records
  profile_prove            — stage and device times of a prove

It imports no JAX and nothing of `zukelang_tpu`: what it takes from the
JAX package it keeps as its own copy.
"""

__version__ = "0.1.0"
