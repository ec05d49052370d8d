"""Multi-rank sharding over torch.distributed: the mesh, the term-sharded
MSM, the four-step all_to_all NTT, the gate-sharded witness evaluation
and reduction, and the sharded Groth16 / Pinocchio proves (`sharded`);
worlds of ranks (`launch`); the scaling harness (`scaling`) and the
dry run (`dryrun`).  Counterpart of `zukelang_tpu/parallel/`."""

from .sharded import (make_mesh, sharded_msm_g1, sharded_ntt,
                      sharded_gate_eval, sharded_prove_step)

__all__ = ["make_mesh", "sharded_msm_g1", "sharded_ntt",
           "sharded_gate_eval", "sharded_prove_step"]
