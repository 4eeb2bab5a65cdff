"""The gather kernels' plain versions against the TPU probes' kernel bodies
(CPU), and the ports of the probes at a small size.

The Pallas bodies run through ``pallas_call`` in interpret mode: the
module-level ``call`` (benchmarks/_pallas_gather_probe.py) and ``make``
(benchmarks/_dyngather_probe.py) with ``pl.pallas_call`` patched, and this
file's copies of the one-line bodies nested in the probes' ``main``. Every
gather must be bit-equal; the row sum is held to a stated tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from benchmarks import _dyngather_probe, _pallas_gather_probe
from tpu_slam_torch.benchmarks import _dyngather_probe as dyn_port
from tpu_slam_torch.benchmarks import _gather_probe as gather_port
from tpu_slam_torch.benchmarks import _pallas_gather_probe as pallas_port
from tpu_slam_torch.kernels.gather import (gather_row_sum,
                                           gather_row_sum_plain, gather_rows,
                                           gather_rows_plain, onehot_gather,
                                           onehot_gather_plain)


@pytest.fixture
def interpret(monkeypatch):
    """pl.pallas_call in interpret mode, as the probes call it."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _vmem_call(kernel, out_shape, *args):
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(args),
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(*args)


def _data(n, rows, cols, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, rows, n).astype(np.int32)
    table = rng.normal(size=(rows, cols)).astype(np.float32)
    return idx, table


def test_pallas_gather_probe_bodies(interpret, monkeypatch):
    """Row 4: the five bodies of _pallas_gather_probe.main through its
    module-level ``call`` (N cut to 512, a 128-row table)."""
    n, rows = 512, 128
    monkeypatch.setattr(_pallas_gather_probe, "N", n)
    idx, table = _data(n, rows, 16, 0)

    def k_take(idx_ref, t_ref, out_ref):
        out_ref[:] = jnp.take(t_ref[:], idx_ref[:], axis=0)

    def k_taa(idx_ref, t_ref, out_ref):
        ii = jnp.broadcast_to(idx_ref[:][:, None], (n, 16))
        out_ref[:] = jnp.take_along_axis(t_ref[:], ii, axis=0)

    def k_adv(idx_ref, t_ref, out_ref):
        out_ref[:] = t_ref[:][idx_ref[:]]

    def k_onehot(idx_ref, t_ref, out_ref):
        def body(c, _):
            ii = idx_ref[pl.ds(c * 128, 128)]
            oh = (ii[:, None] == jax.lax.broadcasted_iota(
                jnp.int32, (128, rows), 1)).astype(jnp.bfloat16)
            out_ref[pl.ds(c * 128, 128), :] = jnp.dot(
                oh, t_ref[:].astype(jnp.bfloat16),
                preferred_element_type=jnp.float32)
            return ()
        jax.lax.fori_loop(0, n // 128, body, ())

    def k_scalar(idx_ref, t_ref, out_ref):
        def body(i, _):
            out_ref[pl.ds(i, 1), :] = t_ref[pl.ds(idx_ref[i], 1), :]
            return ()
        jax.lax.fori_loop(0, n, body, ())

    ti, tt = torch.as_tensor(idx), torch.as_tensor(table)
    rows_port = gather_rows_plain(tt, ti).numpy()
    for body in (k_take, k_taa, k_adv, k_scalar):
        got = np.asarray(_pallas_gather_probe.call(
            body, jnp.asarray(idx), jnp.asarray(table)))
        np.testing.assert_array_equal(rows_port, got, err_msg=body.__name__)
    got = np.asarray(_pallas_gather_probe.call(k_onehot, jnp.asarray(idx),
                                               jnp.asarray(table)))
    np.testing.assert_array_equal(onehot_gather_plain(tt, ti, bf16=True),
                                  got)
    assert not np.array_equal(got, table[idx])     # the rounding is real


def test_gather_probe_row_sum_body():
    """Row 5: _gather_probe's body gk (a row gather, then a row sum)."""
    n, rows = 1024, 2048
    idx, table = _data(n, rows, 16, 1)

    def gk(key_ref, rows_ref, out_ref):
        out_ref[:] = jnp.sum(jnp.take(rows_ref[:], key_ref[:], axis=0),
                             axis=1)

    got = np.asarray(_vmem_call(gk, (n,), jnp.asarray(idx),
                                jnp.asarray(table)))
    port = gather_row_sum_plain(torch.as_tensor(table),
                                torch.as_tensor(idx)).numpy()
    # 16 float32 additions in another order: within 2e-6 of the sum of the
    # row's magnitudes (16 roundings of 6e-8 each at most)
    scale = np.abs(table[idx]).sum(axis=1)
    assert np.all(np.abs(port - got) <= 2e-6 * scale)


def _row_sum_in_stated_order(row):
    """One row's sum in csrc/gather.cu's stated order, written out with
    numpy float32 scalars: units of 4 columns, lanes the least power of two
    at least the units (at most 32), lane l summing units l, l + lanes, ...
    left to right from -0.0, then the lanes pairwise, neighbours first."""
    cols = row.shape[0]
    units = -(-cols // 4)
    lanes = 1
    while lanes < units and lanes < 32:
        lanes *= 2
    partial = []
    for lane in range(lanes):
        acc = np.float32(-0.0)
        for u in range(lane, units, lanes):
            for j in range(4 * u, min(4 * u + 4, cols)):
                acc = np.float32(acc + row[j])
        partial.append(acc)
    while len(partial) > 1:
        partial = [np.float32(partial[2 * k] + partial[2 * k + 1])
                   for k in range(len(partial) // 2)]
    return partial[0]


@pytest.mark.parametrize("cols", [7, 16, 200, 256])
def test_row_sum_plain_takes_the_stated_order(cols):
    """gather_row_sum_plain sums in the kernel's stated order, bit for bit,
    on a table (magnitudes over eight decades) where left to right rounds
    differently."""
    rng = np.random.default_rng(cols)
    rows, n = 50, 64
    table = (rng.normal(size=(rows, cols))
             * 10.0 ** rng.uniform(-4, 4, (rows, cols))).astype(np.float32)
    idx = rng.integers(0, rows, n).astype(np.int32)
    got = gather_row_sum_plain(torch.as_tensor(table),
                               torch.as_tensor(idx)).numpy()
    want = np.array([_row_sum_in_stated_order(table[i]) for i in idx],
                    dtype=np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    left_to_right = table[idx][:, 0].copy()
    for j in range(1, cols):
        left_to_right = left_to_right + table[idx][:, j]
    assert not np.array_equal(got, left_to_right)


@pytest.mark.parametrize("bf16", [False, True])
def test_onehot_plain_keeps_non_finite_values_and_ties(bf16):
    """onehot_gather_plain is the gather of the product's one row: inf and
    NaN stay in their own row (the literal product would spread NaN down
    the column); bfloat16 ties round to even; zero rows outside the
    table."""
    ties = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x7F7FFFFF,
                     0x00008000, 0x80000000], dtype=np.uint32).view(
                         np.float32)
    table = np.zeros((5, 8), dtype=np.float32)
    table[0, :6] = ties
    table[1, :3] = [np.inf, -np.inf, np.nan]
    table[2] = np.arange(8, dtype=np.float32) / 3
    idx = np.array([1, 0, 2, -1, 5, 1], dtype=np.int32)
    got = onehot_gather_plain(torch.as_tensor(table), torch.as_tensor(idx),
                              bf16=bf16).numpy()
    rows = torch.as_tensor(table[np.clip(idx, 0, 4)])
    if bf16:
        rows = rows.to(torch.bfloat16).to(torch.float32)
    want = np.where(((idx >= 0) & (idx < 5))[:, None], rows.numpy(), 0.0)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[[0, 5], 2]).all() and not np.isnan(got[2:5]).any()
    if bf16:       # ties to even: 1 + 2^-8 down, 1 + 3 * 2^-8 up, -1 -
        # 2^-8 down; FLT_MAX up to inf
        assert list(got[1, :4]) == [1.0, 1.015625, -1.0, np.inf]


def test_dyngather_probe_bodies(interpret):
    """Rows 6-8: k_eq through the module-level ``make`` (broadcast and
    per-lane indices), and copies of k_sub and of the f32 one-hot body."""
    def k_eq(idx_ref, t_ref, out_ref):
        out_ref[:] = jnp.take_along_axis(t_ref[:], idx_ref[:], axis=0)

    rng = np.random.default_rng(2)
    m, cols = 256, 128
    table = rng.normal(size=(m, cols)).astype(np.float32)
    tt = torch.as_tensor(table)
    f = _dyngather_probe.make(k_eq, (m, cols))
    bcast = np.ascontiguousarray(np.broadcast_to(
        rng.integers(0, m, m).astype(np.int32)[:, None], (m, cols)))
    lane = rng.integers(0, m, (m, cols)).astype(np.int32)
    for idx in (bcast, lane):
        got = np.asarray(f(jnp.asarray(idx), jnp.asarray(table)))
        np.testing.assert_array_equal(
            gather_rows_plain(tt, torch.as_tensor(idx)).numpy(), got)

    sub = rng.integers(0, m, (m // 2, cols)).astype(np.int32)
    got = np.asarray(_vmem_call(k_eq, (m // 2, cols), jnp.asarray(sub),
                                jnp.asarray(table)))
    np.testing.assert_array_equal(
        gather_rows_plain(tt, torch.as_tensor(sub)).numpy(), got)

    n_oh = 32

    def k_onehot(idx_ref, t_ref, out_ref):
        ii = idx_ref[:, 0]
        oh = (ii[:, None] == jax.lax.broadcasted_iota(
            jnp.int32, (n_oh, m), 1)).astype(jnp.float32)
        out_ref[:] = jnp.dot(oh, t_ref[:], preferred_element_type=jnp.float32)

    idx_oh = rng.integers(0, m, (n_oh, 1)).astype(np.int32)
    got = np.asarray(_vmem_call(k_onehot, (n_oh, cols), jnp.asarray(idx_oh),
                                jnp.asarray(table)))
    np.testing.assert_array_equal(
        onehot_gather_plain(tt, torch.as_tensor(idx_oh[:, 0].copy())), got)


def test_wrappers_run_the_plain_versions_on_the_cpu():
    idx, table = _data(40, 30, 16, 3)
    ti, tt = torch.as_tensor(idx), torch.as_tensor(table)
    cases = ((gather_rows, gather_rows_plain, ()),
             (gather_row_sum, gather_row_sum_plain, ()),
             (onehot_gather, onehot_gather_plain, (True,)))
    for fn, plain, extra in cases:
        before = (fn.launches, plain.launches)
        assert torch.equal(fn(tt, ti, *extra), plain(tt, ti, *extra))
        assert (fn.launches, plain.launches) == (before[0],
                                                 before[1] + 2)


def test_out_of_table_indices_and_bad_inputs():
    idx, table = _data(6, 5, 4, 4)
    idx[[1, 4]] = [-1, 5]
    ti, tt = torch.as_tensor(idx), torch.as_tensor(table)
    rows = gather_rows(tt, ti)
    assert torch.isnan(rows[[1, 4]]).all() and not torch.isnan(
        rows[[0, 2, 3, 5]]).any()
    sums = gather_row_sum(tt, ti)
    assert torch.isnan(sums[[1, 4]]).all()
    oh = onehot_gather(tt, ti)
    assert torch.equal(oh[[1, 4]], torch.zeros(2, 4))
    assert torch.equal(oh[[0, 2]], tt[idx[[0, 2]]])
    with pytest.raises(ValueError):
        gather_rows(tt, ti.long())
    with pytest.raises(ValueError):
        gather_rows(tt.double(), ti)
    with pytest.raises(ValueError):
        gather_row_sum(tt, ti[:, None].expand(6, 4).contiguous())
    with pytest.raises(ValueError):
        gather_rows(tt, torch.zeros((6, 3), dtype=torch.int32))


@pytest.mark.parametrize("probe,kw", [
    (pallas_port, dict(n=256, t=64)),
    (gather_port, dict(n=256, wb=3)),
    (dyn_port, dict(n=256, m=128, ns=64, n_oh=16, rows_oh=64))])
def test_probe_ports_run_and_check_on_the_cpu(probe, kw):
    out = probe.main("cpu", reps=2, **kw)
    assert out["device"] == "cpu"
    results = out.get("variants") or out["forms"]
    assert all(r["ms"] > 0 for r in results.values())
    checked = [r["correct"] for r in results.values() if "correct" in r]
    assert checked and all(checked)


def _bad_inputs():
    """(label, wrapper name, args) of every input the wrappers refuse."""
    tt = torch.zeros(5, 4)
    ti = torch.zeros(6, dtype=torch.int32)
    wide = torch.zeros(1, 2 ** 20)
    return [
        ("int64 idx", "gather_rows", (tt, ti.long())),
        ("float64 table", "gather_rows", (tt.double(), ti)),
        ("1-d table", "gather_rows", (tt[0], ti)),
        ("3-d table", "gather_rows", (tt[None], ti)),
        ("0-d idx", "gather_rows", (tt, ti[0])),
        ("3-d idx", "gather_rows", (tt, ti[:, None, None])),
        ("idx of another width", "gather_rows",
         (tt, torch.zeros((6, 3), dtype=torch.int32))),
        ("2-d idx, row sum", "gather_row_sum",
         (tt, torch.zeros((6, 4), dtype=torch.int32))),
        ("2-d idx, one-hot", "onehot_gather",
         (tt, torch.zeros((6, 4), dtype=torch.int32))),
        ("strided table", "gather_rows", (torch.zeros(5, 8)[:, ::2], ti)),
        ("strided idx", "gather_row_sum",
         (tt, torch.zeros(12, dtype=torch.int32)[::2])),
        ("strided per-element idx", "gather_rows",
         (tt, torch.zeros((6, 8), dtype=torch.int32)[:, ::2])),
        ("table with no rows", "onehot_gather", (tt[:0], ti)),
        ("table with no columns", "gather_rows", (tt[:, :0], ti)),
        ("idx on another device", "gather_rows", (tt, ti.to("meta"))),
        ("table on another device", "gather_row_sum", (tt.to("meta"), ti)),
        ("unsupported device", "onehot_gather",
         (tt.to("meta"), ti.to("meta"))),
        ("output of 2^31 values", "gather_rows",
         (wide, torch.zeros(2048, dtype=torch.int32))),
    ]


@pytest.mark.parametrize("label", [c[0] for c in _bad_inputs()])
def test_wrappers_and_plain_versions_refuse_bad_inputs(label):
    from tpu_slam_torch.kernels import gather as G

    name, args = next((n, a) for lab, n, a in _bad_inputs() if lab == label)
    fns = [getattr(G, name)]
    if label != "unsupported device":     # the plain versions run anywhere
        fns.append(getattr(G, name + "_plain"))
    for fn in fns:
        with pytest.raises(ValueError):
            fn(*args)
