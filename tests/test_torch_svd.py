"""The paper-faithful ``method="svd"`` of the port against the reference:
``rolann``'s factor functions, ``elm_ae``'s svd layer and partition
knowledge, ``daef``'s svd fit, merge and partial fit, and the interop of
factor-knowledge models.

The same numpy inputs, made from a seed, go through ``repro.core`` and
``repro_torch.core`` on the CPU.  Neither package fixes the signs of the
ROLANN factors' U, and near-equal singular values leave its columns free
within their subspace (the port takes U and S from the SVD of the R of a
QR, the reference from LAPACK's SVD), so the factors are compared as

* ``U S² Uᵀ`` (the Gram form, ``factors_to_stats``) and ``M`` at
  ``assert_sum_close``: atol 1e-4 × the leaf's largest entry, the bar of the
  gram tests' (G, M), since both are sums over samples;
* S at ``assert_sum_close`` as well: an SVD fixes every singular value to
  about eps × the largest one, not relative to itself;
* the rank r (the factors' shapes) exactly.

Models are held by ``assert_models_match`` (tests/_torch_parity.py) with
each layer's knowledge in Gram form: TOLS for the encoder and hidden
weights, the κ bar for the last layer, U S² Uᵀ for the encoder.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_models_match, assert_sum_close, lowrank_data

from repro.core import activations as jact
from repro.core import daef as jdaef
from repro.core import elm_ae as jelm
from repro.core import rolann as jrol
from repro_torch import interop
from repro_torch.core import activations as tact
from repro_torch.core import daef as tdaef
from repro_torch.core import dsvd
from repro_torch.core import elm_ae as telm
from repro_torch.core import rolann as trol

T = torch.from_numpy


def _layer_data(act, m=6, o=4, n=300, seed=0):
    """Inputs in [0, 1] and targets in the activation's range (saturated
    ones for logsig get clipped)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, size=(m, n)).astype(np.float32)
    if act == "logsig":
        d = rng.uniform(0.0, 1.0, size=(o, n))
        d[0, :3] = [0.0, 1.0, 0.5]
    elif act == "tanh":
        d = rng.uniform(-0.8, 0.8, size=(o, n))
    else:
        d = rng.normal(size=(o, n))
    return x, d.astype(np.float32)


def factor_stats(f):
    """Factor knowledge of either package in Gram form, as numpy."""
    if isinstance(f, trol.RolannFactors):
        return trol.factors_to_stats(f)
    return jrol.factors_to_stats(f)


def assert_factors_match(tf, jf, what=""):
    """Port factors against reference factors: shapes, U S² Uᵀ, S and M."""
    assert isinstance(tf, trol.RolannFactors)
    assert [tuple(a.shape) for a in tf] == [tuple(a.shape) for a in jf], what
    assert_sum_close(factor_stats(tf).g, factor_stats(jf).g, what=f"{what} U S^2 U^T")
    assert_sum_close(tf.s, jf.s, what=f"{what} S")
    assert_sum_close(tf.m, jf.m, what=f"{what} M")


def as_gram_model(model):
    """A model of either package with each layer's factors in Gram form."""
    lib = trol if isinstance(model, tdaef.DAEFModel) else jrol
    return model._replace(layer_knowledge=tuple(
        lib.factors_to_stats(k) for k in model.layer_knowledge))


def assert_svd_models_match(jm, tm, lam_last):
    """A port svd model against a reference one (see the module docstring)."""
    for i, (tk, jk) in enumerate(zip(tm.layer_knowledge, jm.layer_knowledge, strict=True)):
        assert_factors_match(tk, jk, f"layer {i}")
    assert_models_match(as_gram_model(jm), as_gram_model(tm), lam_last)


# ---------------------------------------------------------------------------
# dsvd.left_svd: U and S from the R of a QR (on the card by a tree of QRs)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,rows", [((3, 1_000, 7), 64), ((2, 300, 28), 32),
                                        ((4, 257, 5), 256), ((50, 6), 64), ((3, 40, 7), 64)])
def test_tree_of_qrs_gives_the_r_of_one_qr(shape, rows):
    """The tree of QRs (the card's route, run here on the CPU) gives an R
    with RᵀR = tᵀt, as one QR does, in float64 to 1e-12 of max|tᵀt|:
    blocks padded with zero rows, several levels, a single block, no
    leading axis, and matrices no taller than a block (one QR)."""
    t = torch.from_numpy(np.random.default_rng(len(shape)).normal(size=shape))
    want = t.transpose(-1, -2) @ t
    for r in (dsvd._tall_r(t, rows), dsvd._tall_r(t, None)):
        assert tuple(r.shape) == (*shape[:-2], shape[-1], shape[-1])
        got = r.transpose(-1, -2) @ r
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("m,n", [(7, 300), (7, 5), (28, 56)])
def test_left_svd_is_the_svds_u_and_s(m, n):
    """U and S of dsvd.left_svd against torch.linalg.svd's, float64: S to
    1e-12 of its largest, U S² Uᵀ likewise, U orthonormal."""
    a = torch.from_numpy(np.random.default_rng(m * n).normal(size=(3, m, n)))
    u, s = dsvd.left_svd(a)
    uw, sw, _ = torch.linalg.svd(a, full_matrices=False)
    assert tuple(u.shape) == (3, m, min(m, n)) and tuple(s.shape) == (3, min(m, n))
    assert float((s - sw).abs().max()) <= 1e-12 * float(sw.max())
    g, gw = (u * s.unsqueeze(-2) ** 2) @ u.transpose(-1, -2), a @ a.transpose(-1, -2)
    assert float((g - gw).abs().max()) <= 1e-12 * float(gw.abs().max())
    eye = torch.eye(min(m, n), dtype=a.dtype)
    assert float((u.transpose(-1, -2) @ u - eye).abs().max()) <= 1e-12


# ---------------------------------------------------------------------------
# rolann
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["logsig", "tanh", "linear"])
@pytest.mark.parametrize("n", [300, 5])
def test_compute_factors_matches_reference(act, n):
    """Per-output factors (one shared set for linear) of rank min(m + 1, n):
    n = 5 samples for 7 rows keeps 5 columns."""
    x, d = _layer_data(act, n=n)
    tf = trol.compute_factors(T(x), T(d), tact.get(act))
    jf = jrol.compute_factors(jnp.asarray(x), jnp.asarray(d), jact.get(act))
    assert tf.shared_f == (act == "linear") == jf.shared_f
    assert tf.s.shape[-1] == min(7, n)
    assert_factors_match(tf, jf)
    assert np.all(np.diff(tf.s.numpy(), axis=-1) <= 0)
    # the same Gram as the gram method's statistics
    assert_sum_close(factor_stats(tf).g, trol.compute_stats(T(x), T(d), tact.get(act)).g)


@pytest.mark.parametrize("backend", ["einsum", "fused"])
def test_compute_factors_via_gram_matches_reference(backend):
    """Factors from eigh of the local Gram (the fused backend's Gram is B1's
    plain version here): the reference's, and the direct SVD's U S² Uᵀ."""
    x, d = _layer_data("logsig")
    tf = trol.compute_factors_via_gram(T(x), T(d), tact.logsig, backend=backend)
    jf = jrol.compute_factors_via_gram(jnp.asarray(x), jnp.asarray(d), jact.logsig,
                                       backend="einsum")
    assert_factors_match(tf, jf)
    direct = trol.compute_factors(T(x), T(d), tact.logsig)
    assert_sum_close(factor_stats(tf).g, factor_stats(direct).g)


@pytest.mark.parametrize("act", ["logsig", "linear"])
def test_factors_to_stats_matches_reference(act):
    x, d = _layer_data(act)
    jf = jrol.compute_factors(jnp.asarray(x), jnp.asarray(d), jact.get(act))
    tf = trol.RolannFactors(*(T(np.array(a)) for a in jf))
    got, want = trol.factors_to_stats(tf), jrol.factors_to_stats(jf)
    assert isinstance(got, trol.RolannStats) and got.shared_f == (act == "linear")
    assert_sum_close(got.g, want.g)
    assert torch.equal(got.m, tf.m)


@pytest.mark.parametrize("form", ["stats", "factors"])
@pytest.mark.parametrize("w", [0.0, 1.0, [1.0, 0.0, 1.0]])
def test_mask_knowledge_matches_reference(form, w):
    """A scalar masks one contribution, a leading vector a stacked batch;
    factors keep U and scale S and M.  Exact (a product by 0 or 1)."""
    x, d = _layer_data("logsig")
    jf = jrol.compute_factors(jnp.asarray(x), jnp.asarray(d), jact.logsig)
    jk = jrol.factors_to_stats(jf) if form == "stats" else jf
    if isinstance(w, list):  # a stack of three contributions
        jk = jax.tree.map(lambda leaf: jnp.stack([leaf, 2 * leaf, 3 * leaf]), jk)
    cls = trol.RolannStats if form == "stats" else trol.RolannFactors
    tk = cls(*(T(np.array(a)) for a in jk))
    got = trol.mask_knowledge(tk, torch.tensor(w) if isinstance(w, list) else w)
    want = jrol.mask_knowledge(jk, jnp.asarray(w))
    assert type(got).__name__ == type(want).__name__
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _partition_factors(act, parts=3, n=300):
    x, d = _layer_data(act, n=n)
    tparts = [trol.compute_factors(T(x[:, i::parts]), T(d[:, i::parts]), tact.get(act))
              for i in range(parts)]
    jparts = [jrol.compute_factors(jnp.asarray(x[:, i::parts]), jnp.asarray(d[:, i::parts]),
                                   jact.get(act)) for i in range(parts)]
    return x, d, tparts, jparts


@pytest.mark.parametrize("act", ["logsig", "linear"])
def test_merge_factors_matches_reference(act):
    """Eq. 8-9 pairwise: the SVD of [U_a S_a | U_b S_b] truncated to rank m,
    M summed; the merge of the three partitions equals the one-shot
    factors (U S² Uᵀ, S and M at the sum bar)."""
    x, d, tparts, jparts = _partition_factors(act)
    tm, jm = tparts[0], jparts[0]
    for tp, jp in zip(tparts[1:], jparts[1:]):
        tm, jm = trol.merge_factors(tm, tp), jrol.merge_factors(jm, jp)
    assert_factors_match(tm, jm)
    assert tm.s.shape[-1] == 7  # truncated to m
    full = trol.compute_factors(T(x), T(d), tact.get(act))
    assert_sum_close(factor_stats(tm).g, factor_stats(full).g)
    assert_sum_close(tm.s, full.s)
    assert_sum_close(tm.m, full.m)


def test_merge_factors_rejects_mixed_layouts():
    _, _, tparts, jparts = _partition_factors("logsig", parts=1)
    _, _, tlin, jlin = _partition_factors("linear", parts=1)
    with pytest.raises(ValueError) as jerr:
        jrol.merge_factors(jparts[0], jlin[0])
    with pytest.raises(ValueError) as terr:
        trol.merge_factors(tparts[0], tlin[0])
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as terr:
        trol.merge_factors_list([tparts[0], tlin[0]])
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="empty factor list"):
        trol.merge_factors_list([])


@pytest.mark.parametrize("act", ["logsig", "linear"])
def test_merge_factors_list_matches_reference(act):
    """One SVD of the whole concatenation: the reference's, and the
    pairwise merges' U S² Uᵀ and S."""
    _, _, tparts, jparts = _partition_factors(act)
    got = trol.merge_factors_list(tparts)
    assert_factors_match(got, jrol.merge_factors_list(jparts))
    pair = trol.merge_factors(trol.merge_factors(tparts[0], tparts[1]), tparts[2])
    assert_sum_close(factor_stats(got).g, factor_stats(pair).g)
    assert_sum_close(got.s, pair.s)
    assert_factors_match(trol.merge_factors_list(tparts[:1]),
                         jrol.merge_factors_list(jparts[:1]))


@pytest.mark.parametrize("act", ["linear", "logsig", "tanh"])
def test_fit_svd_matches_reference_and_gram(act):
    """rolann.fit(method="svd") against the reference's at TOLS, and the
    port's gram fit at the reference's own gram-vs-svd bar (5e-4,
    tests/test_rolann.py)."""
    x, d = _layer_data(act)
    w, b, k = trol.fit(T(x), T(d), tact.get(act), 0.1, method="svd")
    wj, bj, kj = jrol.fit(jnp.asarray(x), jnp.asarray(d), jact.get(act), 0.1, method="svd")
    assert_close(w, wj)
    assert_close(b, bj)
    assert_factors_match(k, kj)
    wg, bg, _ = trol.fit(T(x), T(d), tact.get(act), 0.1, method="gram")
    assert_close(w, wg, atol=5e-4, rtol=0)
    assert_close(b, bg, atol=5e-4, rtol=0)
    with pytest.raises(ValueError, match="unknown ROLANN method"):
        trol.fit(T(x), T(d), tact.get(act), 0.1, method="qr")


def test_partition_merge_equals_full_svd_fit():
    """Three partitions' factors merged pairwise and solved: the one-shot
    svd fit's weights (the reference's test at its 2e-3), and the
    reference's merged weights at TOLS."""
    x, d, tparts, jparts = _partition_factors("logsig")
    w_full, b_full, _ = trol.fit(T(x), T(d), tact.logsig, 0.2, method="svd")
    agg, jagg = tparts[0], jparts[0]
    for tp, jp in zip(tparts[1:], jparts[1:]):
        agg, jagg = trol.merge_factors(agg, tp), jrol.merge_factors(jagg, jp)
    w, b = trol.solve(agg, 0.2)
    assert_close(w, w_full, atol=2e-3, rtol=0)
    assert_close(b, b_full, atol=2e-3, rtol=0)
    wj, bj = jrol.solve(jagg, 0.2)
    assert_close(w, wj)
    assert_close(b, bj)


# ---------------------------------------------------------------------------
# elm_ae
# ---------------------------------------------------------------------------

def _hidden(n=600, seed=2):
    return (1.0 / (1.0 + np.exp(-lowrank_data(6, 3, n, seed=seed)))).astype(np.float32)


def _keys(li=2):
    return tdaef.layer_keys_from_seed(0, 5)[li], jdaef.layer_keys_from_seed(0, 5)[li]


@pytest.mark.parametrize("aux_bias", ["zero", "c1"])
def test_train_layer_svd_matches_reference(aux_bias):
    h = _hidden()
    key, jkey = _keys()
    got = telm.train_layer(key, T(h), 8, 0.5, tact.logsig, aux_bias=aux_bias, method="svd")
    want = jelm.train_layer(jkey, jnp.asarray(h), 8, 0.5, jact.logsig, aux_bias=aux_bias,
                            method="svd")
    assert_close(got.w, want.w)
    assert_close(got.b, want.b)
    assert_close(got.h, want.h)
    assert_factors_match(got.knowledge, want.knowledge)
    w, b = telm.layer_from_knowledge(got.knowledge, key, 6, 8, 0.5, tact.logsig,
                                     aux_bias=aux_bias)
    assert torch.equal(w, got.w) and torch.equal(b, got.b)


@pytest.mark.parametrize("method,factorization", [("gram", "direct_svd"),
                                                  ("svd", "direct_svd"),
                                                  ("svd", "gram_eigh")])
@pytest.mark.parametrize("backend", ["einsum", "fused"])
def test_layer_knowledge_from_partition_matches_reference(method, factorization, backend):
    """One partition's knowledge of a decoder layer in either form, then 4
    partitions merged (a sum, or one SVD of the concatenation): the
    reference's, and the one-shot layer's statistics (1e-4 × max|G|)."""
    h = _hidden(n=800)
    key, jkey = _keys()
    kw = dict(method=method, factorization=factorization)
    parts = [h[:, i * 200:(i + 1) * 200] for i in range(4)]
    got = [telm.layer_knowledge_from_partition(key, T(p), 8, tact.logsig, backend=backend, **kw)
           for p in parts]
    want = [jelm.layer_knowledge_from_partition(jkey, jnp.asarray(p), 8, jact.logsig,
                                                backend="einsum", **kw) for p in parts]
    if method == "gram":
        for g, w in zip(got, want):
            assert_sum_close(g.g, w.g)
            assert_sum_close(g.m, w.m)
        merged = got[0]
        for g in got[1:]:
            merged = trol.merge_stats(merged, g)
    else:
        for g, w in zip(got, want):
            assert_factors_match(g, w)
        merged = trol.merge_factors_list(got)
        assert_factors_match(merged, jrol.merge_factors_list(want))
        merged = trol.factors_to_stats(merged)
    one_shot = telm.train_layer(key, T(h), 8, 0.5, tact.logsig).knowledge
    assert_sum_close(merged.g, one_shot.g)
    assert_sum_close(merged.m, one_shot.m)


# ---------------------------------------------------------------------------
# daef
# ---------------------------------------------------------------------------

KW = dict(layer_sizes=(10, 4, 6, 8, 10), lam_hidden=0.7, lam_last=0.9, method="svd")


def _fit_both(x, n_partitions=1, **kw):
    kw = dict(KW, **kw)
    jcfg, tcfg = jdaef.DAEFConfig(**kw), tdaef.DAEFConfig(**kw)
    jm = jdaef.fit(jcfg, jnp.asarray(x), n_partitions=n_partitions)
    tm = tdaef.fit(tcfg, x, n_partitions=n_partitions, device="cpu")
    return jcfg, tcfg, jm, tm


@pytest.mark.parametrize("n_partitions", [1, 4])
@pytest.mark.parametrize("init", ["xavier", "orthogonal"])
def test_daef_fit_svd_matches_reference(n_partitions, init):
    """The svd fit (the encoder by local SVDs merged by Eq. 2, every layer's
    factors by SVD) leaf by leaf, and its test scores at TOLS."""
    x = lowrank_data(10, 4, 800, seed=0)
    jcfg, tcfg, jm, tm = _fit_both(x, n_partitions, init=init)
    assert all(isinstance(k, trol.RolannFactors) for k in tm.layer_knowledge)
    assert_svd_models_match(jm, tm, 0.9)
    x_test = lowrank_data(10, 4, 200, seed=1)
    assert_close(tdaef.reconstruction_error(tcfg, tm, x_test, device="cpu"),
                 jdaef.reconstruction_error(jcfg, jm, jnp.asarray(x_test)))


def test_daef_svd_method_matches_gram():
    """The reference's own check (tests/test_daef.py): the svd and gram
    fits' weights within 2e-2; the port's svd fit against its gram fit."""
    x = lowrank_data(10, 4, 800, seed=3)
    ms = tdaef.fit(tdaef.DAEFConfig(**KW), x, device="cpu")
    mg = tdaef.fit(tdaef.DAEFConfig(**dict(KW, method="gram")), x, device="cpu")
    for a, b in zip(mg.weights, ms.weights, strict=True):
        assert_close(a, b, atol=2e-2, rtol=0)


def _halves():
    x = lowrank_data(10, 4, 1_000, seed=9)
    return x[:, :550], x[:, 550:]


def test_daef_merge_models_svd_matches_reference():
    """Two partitions' svd models merged (encoders by Eq. 2, each layer's
    factors by Eq. 8-9, one re-solve) against the reference's merge, and
    merge_knowledge's pieces."""
    xa, xb = _halves()
    jcfg, tcfg, ja, ta = _fit_both(xa)
    _, _, jb, tb = _fit_both(xb)
    tm = tdaef.merge_models(tcfg, ta, tb)
    assert_svd_models_match(jdaef.merge_models(jcfg, ja, jb), tm, 0.9)
    _, knowledge, errors = tdaef.merge_knowledge(tcfg, ta, tb)
    assert torch.equal(errors, torch.cat([ta.train_errors, tb.train_errors]))
    for k, a, b in zip(knowledge, ta.layer_knowledge, tb.layer_knowledge, strict=True):
        assert torch.equal(k.m, b.m + a.m)
        assert_sum_close(factor_stats(k).g, factor_stats(a).g + factor_stats(b).g)


def test_daef_partial_fit_svd_matches_reference():
    xa, xb = _halves()
    jcfg, tcfg, jm, tm = _fit_both(xa)
    got = tdaef.partial_fit(tcfg, tm, xb, device="cpu")
    assert_svd_models_match(jdaef.partial_fit(jcfg, jm, jnp.asarray(xb)), got, 0.9)
    assert tuple(got.train_errors.shape) == (1_000,)


def test_daef_svd_merge_matches_the_gram_merge():
    """In exact arithmetic the svd and gram merges of the same halves give
    the same model: each layer's U S² Uᵀ against G and M at the sum bar."""
    xa, xb = _halves()
    gram = tdaef.DAEFConfig(**dict(KW, method="gram"))
    svd = tdaef.DAEFConfig(**KW)
    mg = tdaef.merge_models(gram, tdaef.fit(gram, xa, device="cpu"),
                            tdaef.fit(gram, xb, device="cpu"))
    ms = tdaef.merge_models(svd, tdaef.fit(svd, xa, device="cpu"),
                            tdaef.fit(svd, xb, device="cpu"))
    for ks, kg in zip(ms.layer_knowledge, mg.layer_knowledge, strict=True):
        assert_sum_close(factor_stats(ks).g, kg.g)
        assert_sum_close(ks.m, kg.m)


def test_daef_unknown_method_matches_reference():
    x = lowrank_data(10, 4, 100, seed=4)
    with pytest.raises(ValueError) as jerr:
        jdaef.fit(jdaef.DAEFConfig(**dict(KW, method="qr")), jnp.asarray(x))
    with pytest.raises(ValueError) as terr:
        tdaef.fit(tdaef.DAEFConfig(**dict(KW, method="qr")), x, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_interop_svd_models_both_ways():
    """A factor-knowledge model crosses as the leaves of jax.tree.flatten
    (each layer's u, s, m): a JAX svd model scores in the port as in the
    reference, and the port's flattens to the same leaves in the same order
    and dtypes."""
    x = lowrank_data(10, 4, 400, seed=5)
    jcfg, tcfg, jm, tm = _fit_both(x)
    leaves = [np.asarray(leaf) for leaf in jax.tree.flatten(jm)[0]]
    got = interop.model_from_numpy(tcfg, leaves, device="cpu")
    assert all(isinstance(k, trol.RolannFactors) for k in got.layer_knowledge)
    back = interop.model_to_numpy(got)
    assert len(back) == len(leaves) == 4 + 3 + 2 + 3 * 3 + 1
    for a, b in zip(back, leaves, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    x_test = lowrank_data(10, 4, 100, seed=6)
    assert_close(tdaef.reconstruction_error(tcfg, got, x_test, device="cpu"),
                 jdaef.reconstruction_error(jcfg, jm, jnp.asarray(x_test)))
    # the port's model, read back by the reference's tree
    ours = interop.model_to_numpy(tm)
    rebuilt = jax.tree.unflatten(jax.tree.flatten(jm)[1], [jnp.asarray(a) for a in ours])
    assert_close(jdaef.reconstruction_error(jcfg, rebuilt, jnp.asarray(x_test)),
                 tdaef.reconstruction_error(tcfg, tm, x_test, device="cpu"))
    with pytest.raises(ValueError, match="expected 19 leaves"):
        interop.model_from_numpy(tcfg, leaves[:-1], device="cpu")
