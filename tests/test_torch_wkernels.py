"""The port's step microbenchmarks K7-K9 (hobbyrenderer_tpu_torch/ops/
wkernels.py) against the Pallas microkernels of scripts/bench_wkernels.py
(k1, k2, k2b) run in TPU interpret mode on the CPU, at small sizes: leaf
(4096, 128) with rows 256 and iters 1-2, and Ip 512 with iters 2.

The script's functions are loaded by compiling its source without the
final ``main()`` call. The bf16 tables cross as float32 values already
rounded to bf16 and are cast to torch.bfloat16 on the port's side. Every
output is a gather and a sum in the same order on both sides: the gate is
exact equality (measured max |delta| 0)."""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hobbyrenderer_tpu_torch.ops import wkernels as wk

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts", "bench_wkernels.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers on one machine: one torch thread
    each keeps the plain versions' many small ops from oversubscribing the
    cores (each op's thread team otherwise waits on descheduled threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def script():
    """The script's namespace, without running its main()."""
    with open(SCRIPT) as f:
        tree = ast.parse(f.read(), SCRIPT)
    last = tree.body[-1]
    assert isinstance(last, ast.Expr) and isinstance(last.value, ast.Call) \
        and getattr(last.value.func, "id", None) == "main"
    tree.body = tree.body[:-1]
    ns = {"__name__": "bench_wkernels"}
    exec(compile(tree, SCRIPT, "exec"), ns)
    return ns


def _bf16_values(a):
    """float32 values rounded to bf16 (as the script's astype(bfloat16))."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("iters", [1, 2])
def test_leaf_gather_matches_pallas(script, iters):
    rng = np.random.default_rng(11)
    leaf = rng.random((4096, wk.LANE), np.float32)
    idx = rng.integers(0, 4096, (wk.SUB, wk.LANE)).astype(np.int32)
    rows = 256
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(script["k1"](jnp.asarray(idx), jnp.asarray(leaf), iters=iters,
                                       rows=rows))
    got, checksum = wk.leaf_gather(torch.from_numpy(idx), torch.from_numpy(leaf), rows, iters)
    assert got.shape == (wk.SUB, wk.LANE) and checksum.shape == (rows,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, leaf[idx.reshape(-1)[:wk.SUB]])


@pytest.mark.parametrize("hc", [False, True], ids=["k2", "k2b"])
def test_int_fetch_matches_pallas(script, hc):
    rng = np.random.default_rng(12)
    Ip, iters = 512, 2
    tab = _bf16_values(rng.random((96, Ip), np.float32))
    idx = rng.integers(0, Ip, (wk.SUB, wk.LANE)).astype(np.int32)
    tab_t = torch.from_numpy(tab).to(torch.bfloat16)
    if hc:
        tab_hc = tab.reshape(96, Ip // 128, 128).transpose(1, 0, 2).reshape(-1, 128)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(script["k2b"](jnp.asarray(idx), jnp.asarray(tab_hc, jnp.bfloat16),
                                            iters=iters, Ip=Ip))
        np.testing.assert_array_equal(wk.hc_table(tab_t).to(torch.float32).numpy(), tab_hc)
        got, checksum = wk.int_fetch_hc(torch.from_numpy(idx), wk.hc_table(tab_t), iters, Ip)
    else:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(script["k2"](jnp.asarray(idx), jnp.asarray(tab, jnp.bfloat16),
                                           iters=iters, Ip=Ip))
        got, checksum = wk.int_fetch(torch.from_numpy(idx), tab_t, iters, Ip)
    assert got.shape == (1, wk.LANE) and checksum.shape == (wk.SUB, wk.LANE)
    np.testing.assert_array_equal(got.numpy(), want)
    # the numpy formula: row 0 of the last step's columns, added over g in order
    acc = np.zeros(wk.LANE, np.float32)
    for g in range(wk.SUB):
        acc = acc + tab[0, (idx[g] + iters - 1) % Ip]
    np.testing.assert_array_equal(want[0], acc)


@pytest.mark.parametrize("Ip, hc", [(4480, False), (512, False), (4480, True)],
                         ids=["k8-4480", "k8-512", "k9-4480"])
def test_int_fetch_layout(Ip, hc):
    """The kernel's shared-memory layout (computed here, passed to the
    kernel): every column (K8) or 128-column hc block (K9) is owned by
    exactly one CTA of the cluster (K9's blocks may span two CTAs' slices,
    each column of them in one), a CTA's slice fits its shared memory, and
    one column's 96 values are 192 contiguous 16-byte-aligned bytes, so a
    warp reads them as twelve 16-byte pieces, each 8-lane phase from 32
    distinct 4-byte banks."""
    lay = wk.int_fetch_layout(Ip, hc)
    C, cols, pitch = lay["cluster"], lay["cols"], lay["pitch"]
    assert C in (1, 2, 4, 8) and wk.LANE % C == 0 and cols % 8 == 0
    owner = np.full(Ip, -1)
    for r in range(C):          # CTA rank r holds columns [r * cols, (r + 1) * cols)
        seg = owner[r * cols:(r + 1) * cols]
        assert (seg == -1).all()
        seg[:] = r
    assert (owner >= 0).all()
    if hc:                      # every 8-column staging run lies inside one hc block
        runs = np.arange(0, Ip, 8)
        assert (runs // wk.LANE == (runs + 7) // wk.LANE).all()
    assert pitch >= wk.NCOL and pitch * 2 % 16 == 0
    assert cols * pitch * 2 <= lay["smem"] <= wk.SMEM_LIMIT == 232_448
    for j in (0, 1, cols - 1):  # local column j: byte j * pitch * 2, pieces 16 B each
        words = [(j * pitch * 2 + 16 * k) // 4 + w for k in range(wk.NCOL // 8) for w in range(4)]
        for phase in range(0, len(words), 32):
            banks = [w % 32 for w in words[phase:phase + 32]]
            assert len(set(banks)) == len(banks), (j, phase, banks)
    assert (C == 1) == (Ip == 512)     # one CTA holds the Ip-512 table, Ip 4480 needs 8


def test_int_fetch_layout_rejects_a_table_too_large_for_a_cluster():
    # 96 x 10,000 bf16 is 1.92 MB: an eighth of it is over a CTA's 232,448 bytes
    assert wk.int_fetch_layout(9600, False)["cluster"] == wk.MAX_CLUSTER
    with pytest.raises(ValueError):
        wk.int_fetch_layout(10_000, False)
    with pytest.raises(ValueError):
        wk.int_fetch_layout(500, True)       # the hc table needs whole 128-column blocks


def test_wrappers_reject_bad_shapes():
    idx = torch.zeros((wk.SUB, wk.LANE), dtype=torch.int32)
    with pytest.raises(ValueError):
        wk.leaf_gather(idx, torch.zeros((64, wk.LANE)), rows=8, iters=1)
    with pytest.raises(ValueError):
        wk.int_fetch_hc(idx, torch.zeros((96, 500), dtype=torch.bfloat16), 1, 500)


@pytest.mark.cuda
def test_kernels_match_plain_on_gpu():
    """On the card, at the script's full shapes and 64 steps: K7 and K8 / K9
    (every variant) against their plain versions, `out` bit-exact and the
    checksum within 1e-5 relative (its sums run in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from hobbyrenderer_tpu_torch.bench_wkernels import IP, ITERS, make_inputs
    x = make_inputs(torch.device("cuda"))
    got, _ = wk.leaf_gather(x["idx_rand"], x["leaf"], 512, 4)
    want, _ = wk.leaf_gather_reference(x["idx_rand"], x["leaf"], 512, 4)
    assert torch.equal(got, want)
    for fn, ref, idx, tab, Ip in (
            (wk.int_fetch, wk.int_fetch_reference, x["idx_ip"], x["tab"], IP),
            (wk.int_fetch, wk.int_fetch_reference, x["idx_512"], x["tab512"], 512),
            (wk.int_fetch_hc, wk.int_fetch_hc_reference, x["idx_ip"], x["tab_hc"], IP)):
        got, cs = fn(idx, tab, ITERS, Ip)
        want, want_cs = ref(idx, tab, ITERS, Ip)
        assert torch.equal(got, want)
        assert float(((cs - want_cs).abs() / want_cs.abs()).max()) <= 1e-5
