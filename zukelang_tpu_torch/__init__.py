"""zukelang_tpu_torch — the PyTorch/CUDA port of zukelang_tpu.

The JAX package (`zukelang_tpu`) stays the reference.  This package runs
Groth16 and Pinocchio (NonZK and ZK) keygen, prove and verify on an
NVIDIA GPU, or sharded over a group of ranks, with the Pallas kernels of
the reference rewritten as CUDA C++ for sm_90a (`csrc/`), and on the CPU
through each kernel's plain PyTorch version.

Layering (bottom to top), each module named after its JAX counterpart:
  params                   — curve constants, limb-32 Montgomery constants
  golden/, rng, serialize  — host oracle (field, curve, pairing), the
                             scalar streams, keypair JSON helpers
  native, pairing          — the host C++ pairing (hostsrc/), built at use
  build                    — nvcc build of csrc/*.cu, loaded with ctypes
  ops/kernels              — kernel wrappers, plain versions, launch counts
  ops/field, ops/curve     — field and curve arithmetic on limb tensors
  ops/ntt, ops/msm         — NTT, Pippenger and fixed-base MSM, the whole
                             MSM (msm_g1 / msm_g2)
  core/                    — the DSL (lang), its compiler (comp), circuits,
                             QAPs, polynomials; flat: flattened circuits
  engine/                  — the Engine seam: GoldenEngine, and
                             TorchEngine (witness reduction, evaluation at
                             tau, dots, powers, fixed-base batches)
  protocols/               — Groth16 and Pinocchio over an engine, batch
                             verification, and the device-resident
                             Groth16 and Pinocchio; protocols/device: the
                             device provers' shared steps (the prove's
                             MSM executor and spans, the keygen steps)
  testing/, frontend/      — the harness and the reference suite; the
                             Python-syntax front end
  __main__                 — the CLI (compile, prove, verify, bench, test)
  vectors                  — the frozen x^3+x+3 vectors (testdata/)
  bench_lib                — synthetic R1CS, the Groth16 and Pinocchio
                             bench runs
  bench_rung, bench        — one bench rung as a process; the bench that
                             runs the rungs and prints JSON records
  profile_prove            — stage and device times of a prove
  parallel/                — the multi-rank slice over torch.distributed
                             (NCCL on cards, gloo on the CPU): sharded
                             MSM, four-step NTT, gate evaluation, witness
                             reduction and Groth16 / Pinocchio proves;
                             worlds of ranks (launch), the scaling harness
                             and the dry run

It imports no JAX and nothing of `zukelang_tpu`: what it takes from the
JAX package it keeps as its own copy.
"""

__version__ = "0.1.0"
