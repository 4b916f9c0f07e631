"""The fused J/K build of nbed_tpu_torch against the Pallas kernel of
nbed_tpu (interpret mode on the CPU) and against float64 numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbed_tpu.ops import fused_jk as ref_fused_jk
from nbed_tpu_torch.ops import jk

torch.set_num_threads(1)

NAO = 12


def _problem(seed=7, nao=NAO):
    m = nao * nao
    rng = np.random.default_rng(seed)
    g_j = rng.standard_normal((m, m))
    g_k = rng.standard_normal((m, m))
    dm = rng.standard_normal((2, nao, nao))
    return g_j, g_k, dm + dm.swapaxes(-1, -2)


def _numpy_jk(g_j, g_k, dm):
    n = dm.shape[-1]
    j = (g_j @ (dm[0] + dm[1]).reshape(-1)).reshape(n, n)
    k = (g_k @ dm.reshape(2, -1).T).T.reshape(2, n, n)
    return j, k


def test_matches_pallas_kernel_f32():
    """Tolerances of tests/test_ops.py:25-26 (float32 in and out)."""
    g_j, g_k, dm = _problem()
    j_ref, k_ref = ref_fused_jk(jnp.asarray(g_j), jnp.asarray(g_k), jnp.asarray(dm),
                                tile_m=128, tile_c=128, interpret=True)
    j, k = jk.fused_jk(*(torch.tensor(a, dtype=torch.float32) for a in (g_j, g_k, dm)))
    assert j.dtype == torch.float32 and k.shape == (2, NAO, NAO)
    np.testing.assert_allclose(j.numpy(), np.asarray(j_ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(k.numpy(), np.asarray(k_ref), rtol=1e-5, atol=1e-4)


def test_matches_numpy_f64():
    g_j, g_k, dm = _problem(seed=3)
    j_np, k_np = _numpy_jk(g_j, g_k, dm)
    j, k = jk.fused_jk(*(torch.tensor(a) for a in (g_j, g_k, dm)))
    np.testing.assert_allclose(j.numpy(), j_np, rtol=0, atol=1e-12)
    np.testing.assert_allclose(k.numpy(), k_np, rtol=0, atol=1e-12)


def test_cpu_tensors_take_plain_version_without_launch():
    before = dict(jk.LAUNCHES)
    for dtype in (torch.float64, torch.float32):
        jk.fused_jk(*(torch.tensor(a, dtype=dtype) for a in _problem(nao=3)))
    assert dict(jk.LAUNCHES) == before


@pytest.mark.parametrize("case", ["shape", "device"])
def test_kernel_argument_checks(case):
    g_j, g_k, dm = (torch.tensor(a) for a in _problem(nao=3))
    if case == "shape":
        with pytest.raises(ValueError, match="g_j must be"):
            jk.FusedJK(g_j[:-1], g_k)
    else:
        with pytest.raises(ValueError, match="CUDA device"):
            jk.FusedJK(g_j, g_k)


@pytest.mark.parametrize("case", ["not square", "not nao^2", "g_k shape", "mixed dtype",
                                  "integer dtype", "cpu device"])
def test_prepared_argument_checks(case):
    """The prepared object checks G at construction, before it touches a
    card; every miss raises."""
    g_j, g_k, _ = (torch.tensor(a) for a in _problem(nao=3))
    args, err, match = {
        "not square": ((g_j[:, :-1], g_k), ValueError, "g_j must be"),
        "not nao^2": ((g_j[:8, :8], g_k[:8, :8]), ValueError, "nao\\^2"),
        "g_k shape": ((g_j, g_k[:-1]), ValueError, "g_k must be"),
        "mixed dtype": ((g_j, g_k.float()), TypeError, "one dtype"),
        "integer dtype": ((g_j.long(), g_k.long()), TypeError, "float32 or float64"),
        "cpu device": ((g_j, g_k), ValueError, "CUDA device"),
    }[case]
    with pytest.raises(err, match=match):
        jk.FusedJK(*args)


M_CASES = [1, 25, 49, 64, 144, 324, 4096, 9025, 16384]
WORDS = {"f32": 4, "f64": 8}
SMS = 132  # the H100's SM count


def _chunks(p):
    """Column chunks [c0, c1) of a plan (one for every path but chunked)."""
    width = p.chunk_cols if p.path == "chunked" else p.m
    return [(c0, min(c0 + width, p.m)) for c0 in range(0, p.m, width)]


@pytest.mark.parametrize("dtype", sorted(WORDS))
@pytest.mark.parametrize("m", M_CASES)
def test_plan_split_covers_every_column_once(m, dtype):
    """Head, body and tail tile each chunk of each row; bodies start on a
    16-byte boundary and are whole vectors; heads and tails are shorter
    than a vector; the ring's stages cut each body into 16-byte multiples."""
    word = WORDS[dtype]
    p = jk.plan(m, word, SMS)
    rows = np.arange(m)
    covered = np.zeros(m, dtype=np.int64)
    for c0, c1 in _chunks(p):
        head, body, tail = jk.split(m, word, rows, c0, c1)
        assert np.all(head >= 0) and np.all(body >= 0) and np.all(tail >= 0)
        assert np.all(head + body + tail == c1 - c0)
        assert np.all(head < 16 // word) and np.all((tail < 16 // word) | (body == 0))
        assert np.all(((rows * m + c0 + head) * word) % 16 == 0)
        assert np.all((body * word) % 16 == 0)
        covered += head + body + tail
        if p.path != "vector":
            assert (p.seg_elems * word) % 128 == 0
            last = body % p.seg_elems
            assert np.all((last * word) % 16 == 0)
    assert np.all(covered == m)


@pytest.mark.parametrize("dtype", sorted(WORDS))
@pytest.mark.parametrize("m", M_CASES)
def test_plan_fits_the_card(m, dtype):
    """Dynamic shared memory within the block limit; 0 < grid <= rows; the
    ring at most one block per SM."""
    p = jk.plan(m, WORDS[dtype], SMS)
    assert 0 <= p.smem_bytes <= jk.SMEM_MAX == 232448
    assert 0 < p.grid <= m
    if p.path == "vector":
        assert p.smem_bytes == 0 and 1 <= p.warps <= 8 and p.grid * p.warps <= 64 * SMS
    else:
        assert p.grid <= SMS and p.warps == 8 and 3 <= p.stages <= 8
        assert p.smem_bytes == (1024 + 2 * p.stages * p.seg_elems * p.word
                                + 2 * p.chunk_cols * p.word)


@pytest.mark.parametrize("dtype", sorted(WORDS))
@pytest.mark.parametrize("m", M_CASES)
def test_plan_chunks_exactly_where_densities_do_not_fit(m, dtype):
    """Resident densities (chunk = M) wherever 2 M words fit beside a ring
    of 3 stages of 4 KB per matrix; the chunked path only where they do
    not; short rows take the vector path."""
    word = WORDS[dtype]
    p = jk.plan(m, word, SMS)
    fits = 1024 + 2 * m * word + 3 * 2 * 4096 <= jk.SMEM_MAX
    if m * word < jk.RING_MIN_ROW_BYTES:
        assert p.path == "vector"
    else:
        assert (p.path == "chunked") == (not fits)
        assert p.chunk_cols == m if fits else p.chunk_cols < m
        assert jk.plan(m, word, SMS, path="ring").path == p.path
    assert jk.plan(m, word, SMS, path="chunked").path == "chunked"


def test_forced_chunk_that_does_not_fit_raises():
    with pytest.raises(ValueError, match="does not fit"):
        jk.plan(16384, 8, SMS, path="chunked", chunk_cols=16384)


def test_cpu_engine_takes_plain_version(monkeypatch):
    """SCFEngine on the CPU contracts J/K with fused_jk_reference, in both
    dtypes, and launches nothing."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.scf import SCFEngine

    calls = []
    plain = jk.fused_jk_reference
    monkeypatch.setattr(jk, "fused_jk_reference",
                        lambda g_j, g_k, dm: calls.append(dm.dtype) or plain(g_j, g_k, dm))
    xyz = "2\n\nH 0.0 0.0 0.0\nH 0.0 0.0 0.74\n"
    eng = SCFEngine(build_molecule(xyz, "sto-3g"), device="cpu", warmup_f32=True)
    before = dict(jk.LAUNCHES), dict(jk.LAUNCHES_BY_SHAPE)
    dm = torch.eye(2, dtype=torch.float64)
    j, k = eng.get_jk(torch.stack([dm, dm]))
    j_ref, k_ref = plain(eng.eri_j, eng.eri_k, torch.stack([dm, dm]))
    torch.testing.assert_close(j, j_ref, rtol=0, atol=0)
    torch.testing.assert_close(k, k_ref, rtol=0, atol=0)
    eng._f32_ops["jk_fn"](torch.stack([dm, dm]).float())
    assert calls == [torch.float64, torch.float32]
    assert not isinstance(eng._jk_exact, jk.FusedJK)
    assert (dict(jk.LAUNCHES), dict(jk.LAUNCHES_BY_SHAPE)) == before


@pytest.mark.cuda
@pytest.mark.parametrize("nao", [5, 7, NAO])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float64, 1e-12, 1e-10),
                                             (torch.float32, 1e-5, 1e-4)])
def test_cuda_kernel_matches_plain(dtype, rtol, atol, nao):
    """Every path (nao 5 and 7: odd M, misaligned rows), bitwise equal
    launches, one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g_j, g_k, dm = (torch.tensor(a, dtype=dtype, device="cuda")
                    for a in _problem(nao=nao))
    key = "fused_jk_f64" if dtype == torch.float64 else "fused_jk_f32"
    j_ref, k_ref = jk.fused_jk_reference(g_j, g_k, dm)
    for path in (None, "vector", "ring", "chunked"):
        prepared = jk.FusedJK(g_j, g_k, path=path, chunk_cols=nao * nao // 3 + 1)
        before = jk.LAUNCHES[key]
        j, k = prepared(dm)
        j2, k2 = prepared(dm)
        torch.cuda.synchronize()
        assert jk.LAUNCHES[key] == before + 2
        torch.testing.assert_close(j, j_ref, rtol=rtol, atol=atol)
        torch.testing.assert_close(k, k_ref, rtol=rtol, atol=atol)
        assert torch.equal(j, j2) and torch.equal(k, k2)
    j, k = jk.fused_jk(g_j, g_k, dm)
    torch.testing.assert_close(j, j_ref, rtol=rtol, atol=atol)


def _lanes(b, nao, seed=5):
    """(g_j, g_k, dm) of ``b`` lanes: (B, M, M) supermatrices and (B, 2,
    nao, nao) densities."""
    parts = [_problem(seed=seed + i, nao=nao) for i in range(b)]
    return tuple(torch.tensor(np.stack([p[k] for p in parts])) for k in range(3))


def test_plain_lanes_equal_single_builds_exactly():
    """Each lane and row of the plain lane/slab version is the single
    build's, bitwise; B = 1, R = M is the single build."""
    g_j, g_k, dm = _lanes(3, 7)
    m = 49
    out = jk.fused_jk_reference(g_j, g_k, dm)
    assert out.shape == (3, 3, m)
    for b in range(3):
        j, k = jk.fused_jk_reference(g_j[b], g_k[b], dm[b])
        assert torch.equal(out[b, 0], j.reshape(-1))
        assert torch.equal(out[b, 1:], k.reshape(2, -1))
    for r0, r1 in ((0, 25), (25, 49), (10, 30)):  # a model axis of 2, and a middle slab
        slab = jk.fused_jk_reference(g_j[:, r0:r1], g_k[:, r0:r1], dm)
        assert torch.equal(slab, out[..., r0:r1])
    one = jk.fused_jk_reference(g_j[:1], g_k[:1], dm[:1])
    j, k = jk.fused_jk_reference(g_j[0], g_k[0], dm[0])
    assert torch.equal(one[0, 0].reshape(7, 7), j) and torch.equal(one[0, 1:].reshape(2, 7, 7), k)


@pytest.mark.parametrize("dtype", sorted(WORDS))
@pytest.mark.parametrize("m,rows,batch", [(49, 49, 8), (324, 324, 36), (324, 162, 1),
                                          (576, 288, 1), (4096, 2048, 1), (4096, 4096, 3),
                                          (9025, 4513, 2), (16384, 8192, 1)])
def test_plan_lanes_and_slabs(m, rows, batch, dtype):
    """A lane/slab plan keeps the single build's path and ring geometry (they
    follow the row length); the vector path's warps cover the B * R rows
    at full occupancy, the ring takes at most one block per SM and row;
    the split tiles every row of the flattened (B * R, M) matrix."""
    word = WORDS[dtype]
    p = jk.plan(m, word, SMS, rows=rows, batch=batch)
    full = jk.plan(m, word, SMS)
    assert (p.rows, p.batch, p.path) == (rows, batch, full.path)
    assert (p.stages, p.seg_elems, p.chunk_cols, p.smem_bytes) == (
        full.stages, full.seg_elems, full.chunk_cols, full.smem_bytes)
    if p.path == "vector":
        assert 1 <= p.warps <= 8 and p.grid * p.warps <= 64 * SMS
        assert p.grid * p.warps >= min(batch * rows, 64 * SMS // 8)
    else:
        assert p.grid == min(rows, SMS)
    flat = np.arange(batch * rows)
    for c0, c1 in _chunks(p):
        head, body, tail = jk.split(m, word, flat, c0, c1)
        assert np.all(head + body + tail == c1 - c0)
        assert np.all(((flat * m + c0 + head) * word) % 16 == 0)


def test_single_plan_unchanged_by_lane_fields():
    """B = 1, R = M plans exactly as the single build always has."""
    for m in M_CASES:
        for word in (4, 8):
            p = jk.plan(m, word, SMS)
            q = jk.plan(m, word, SMS, rows=m, batch=1)
            assert p == q and p.rows == m and p.batch == 1


@pytest.mark.parametrize("case", ["rows above M", "g_k shape", "cpu device"])
def test_lane_argument_checks(case):
    g_j, g_k, _ = _lanes(2, 3)
    args, match = {
        "rows above M": ((torch.cat([g_j, g_j], 1), torch.cat([g_k, g_k], 1)), "1 <= R <= M"),
        "g_k shape": ((g_j, g_k[:, :-1]), "g_k must be"),
        "cpu device": ((g_j[:, :4], g_k[:, :4]), "CUDA device"),
    }[case]
    with pytest.raises(ValueError, match=match):
        jk.FusedJK(*args)


def test_forward_ad_jk_tangent_on_cpu():
    """Under forward AD the lane J/K's tangent is JK(G, dD) + JK(dG, D)."""
    from torch.autograd import forward_ad

    g_j, g_k, dm = _lanes(2, 4)
    tg_j, tg_k, t_dm = _lanes(2, 4, seed=40)
    with forward_ad.dual_level():
        out = jk.forward_ad_jk(forward_ad.make_dual(g_j, tg_j),
                               forward_ad.make_dual(g_k, tg_k))(forward_ad.make_dual(dm, t_dm))
        tangent = forward_ad.unpack_dual(out).tangent
    ref = jk.fused_jk_reference(g_j, g_k, t_dm) + jk.fused_jk_reference(tg_j, tg_k, dm)
    torch.testing.assert_close(tangent, ref, rtol=1e-13, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("nao,rows,batch", [(7, 49, 8), (7, 25, 3), (5, 13, 1)])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float64, 1e-12, 1e-10),
                                             (torch.float32, 1e-5, 1e-4)])
def test_cuda_lane_kernel_matches_plain(dtype, rtol, atol, nao, rows, batch):
    """Lanes and slabs on every path against the plain version; bitwise
    equal launches; one launch per call, counted by (dtype, M, R, B)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g_j, g_k, dm = (t.to(dtype=dtype, device="cuda") for t in _lanes(batch, nao))
    g_j, g_k = g_j[:, :rows].contiguous(), g_k[:, :rows].contiguous()
    key = "fused_jk_f64" if dtype == torch.float64 else "fused_jk_f32"
    ref = jk.fused_jk_reference(g_j, g_k, dm)
    for path in (None, "vector", "ring", "chunked"):
        prepared = jk.FusedJK(g_j, g_k, path=path, chunk_cols=nao * nao // 3 + 1)
        before = jk.LAUNCHES_BY_SHAPE[(key, nao * nao, rows, batch)]
        out, out2 = prepared(dm), prepared(dm)
        torch.cuda.synchronize()
        assert jk.LAUNCHES_BY_SHAPE[(key, nao * nao, rows, batch)] == before + 2
        torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
        assert torch.equal(out, out2)
