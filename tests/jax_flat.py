"""The port's ragged flat sides against the JAX package's dense ones.

The JAX package pads every row of a side to the widest, (G, K), with the
padding column V and coefficient 0; the port keeps each row's own terms.
`assert_side_matches_jax` checks that the port's side holds exactly the
JAX side's terms that are not padding, in row order, and the same
var-sorted triplets."""

import numpy as np

from zukelang_tpu_torch.ops import field as F


def assert_side_matches_jax(sj, st, n_pad_col: int) -> None:
    live = np.asarray(sj.idx) != n_pad_col
    assert np.array_equal(st.offsets,
                          np.concatenate([[0], np.cumsum(live.sum(1))]))
    assert np.array_equal(st.cols, np.asarray(sj.idx)[live])
    assert np.array_equal(F.to_jax(F._as_tensor(st.coef), axis=0),
                          np.asarray(sj.coef)[:, live])
    assert np.array_equal(sj.t_var, st.t_var)
    assert np.array_equal(sj.t_gate, st.t_gate)
    assert np.array_equal(F.to_jax(F._as_tensor(st.t_coef)), sj.t_coef)
