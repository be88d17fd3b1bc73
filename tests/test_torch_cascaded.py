"""The cascaded branch's modules in the port against the JAX package, on the
same numpy-seeded inputs and JAX params carried over by convert.from_jax:
kw-BN (every layout, with running statistics other than the init's), VQ
(every temperature form), the cosine scores, the CLIP text tower
(``encode_keywords`` at K + 2 tokens against ``encode_text`` on the full
77-token buffer, and both against JAX), the reduced vocabulary, the
cascaded branch at tiny dims; at full width, one cascaded
MultiheadAttentionAndNorm (D = 768, one head) and one text layer (width
512, 8 heads, causal over K + 2 = 10 tokens) under "auto" and under
"pallas" (JAX as on one TPU: its flash kernel in interpret mode, Dh = 768
included); the route table of those layers at base width.

Tolerances: f32 — max abs diff <= 1e-4 (1e-5 where both sides run the same
port code); bf16 — per-row cosine >= 0.999 (the JAX XLA path rounds in
other places than the port's plain layers).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.config import flagship_tiny_config
from speechclip_tpu.kernels import flash_attention as jfa
from speechclip_tpu.models import branches as jb
from speechclip_tpu.models import clip as jclip
from speechclip_tpu.ops import attention as jattn
from speechclip_tpu.ops import kw_bn as jkw
from speechclip_tpu.ops import transformer as jtr
from speechclip_tpu.ops import vq as jvq
from speechclip_tpu_torch import config as port_config
from speechclip_tpu_torch.convert.from_jax import speechclip_params_from_jax
from speechclip_tpu_torch.models import branches as pb
from speechclip_tpu_torch.models import clip as pclip
from speechclip_tpu_torch.models.speechclip import REPO_ROOT, cast_params
from speechclip_tpu_torch.ops import attention as pattn
from speechclip_tpu_torch.ops import kw_bn as pkw
from speechclip_tpu_torch.ops import transformer as ptr
from speechclip_tpu_torch.ops import vq as pvq
from tests.test_torch_config import cascaded_config_from_jax
from tests.test_torch_hubert import DTYPES, assert_match

torch.set_num_threads(2)

T = 37
LENS = np.array([37, 20, 1], np.int32)


def _jdt(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


def _tensors(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


@pytest.mark.parametrize("layout", [("eachKw", True), ("eachKw", False), ("same", False)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kw_bn_matches_jax(layout, dtype):
    bn_type, parallel = layout
    k, d = 4, 24
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((50, d)).astype(np.float32)
    kw = rng.standard_normal((3, k, d)).astype(np.float32)
    jparams, jstate = jkw.kw_bn_init(k, d, bn_type, jnp.mean(emb, 0), jnp.std(emb, 0, ddof=1),
                                     std_scale=0.5, parallel=parallel)
    pparams, pstate = pkw.kw_bn_init(k, d, bn_type, torch.from_numpy(emb).mean(0),
                                     torch.from_numpy(emb).std(0), std_scale=0.5,
                                     parallel=parallel)
    for name in ("scale", "bias"):
        np.testing.assert_allclose(pparams[name].numpy(), np.asarray(jparams[name]), atol=1e-6)
    # running statistics other than the init's, the same on both sides
    state = {"mean": 0.3 * rng.standard_normal(jstate["mean"].shape).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, jstate["var"].shape).astype(np.float32)}
    want, _ = jkw.kw_bn_apply(jparams, jax.tree.map(jnp.asarray, state),
                              jnp.asarray(kw).astype(_jdt(dtype)),
                              batchnorm_type=bn_type, parallel=parallel)
    got, _ = pkw.kw_bn_apply(pparams, _tensors(state), torch.from_numpy(kw).to(dtype),
                          batchnorm_type=bn_type, parallel=parallel)
    assert got.dtype == dtype
    assert_match(got, want, dtype)


def test_kw_bn_parallel_keeps_the_std_index_quirk():
    """Feature d*K + k starts at std[(d*K + k) % D], not std[d]."""
    k, d = 3, 5
    std = torch.arange(1.0, d + 1)
    params, _ = pkw.kw_bn_init(k, d, "eachKw", torch.zeros(d), std, parallel=True)
    idx = torch.arange(d * k)
    torch.testing.assert_close(params["scale"], std[idx % d])


@pytest.mark.parametrize("temp", ["fixed=0.1", "learnable=0.5", "(2.0, 0.5, 0.99)", 0.25])
@pytest.mark.parametrize("gt_perplexity", [None, 20.0])
def test_vq_matches_jax(temp, gt_perplexity):
    rng = np.random.default_rng(2)
    scores = rng.uniform(-1, 1, (3, 4, 64)).astype(np.float32)
    scores[0, 1, 2] = 5.0  # a special token's score is masked out
    assert pvq.parse_temp_spec(temp) == jvq.parse_temp_spec(temp)
    num_updates = 40
    want = jvq.vq_apply(jvq.vq_init(temp), jnp.asarray(scores), temp_spec=temp,
                        num_updates=jnp.asarray(num_updates),
                        ground_truth_perplexity=gt_perplexity)
    got = pvq.vq_apply(_tensors(jvq.vq_init(temp)), torch.from_numpy(scores), temp_spec=temp,
                       num_updates=torch.tensor(num_updates),
                       ground_truth_perplexity=gt_perplexity)
    assert set(got) == set(want)
    assert got["num_vars"] == want["num_vars"] == 64
    np.testing.assert_array_equal(got["targets"].numpy(), np.asarray(want["targets"]))
    for key in ("subword_prob", "code_perplexity", "prob_perplexity", "ent_per_t",
                "diversity_loss", "temp"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-6)
    assert int(got["targets"][0, 1, 0]) != 2


def test_cosine_scores_match_jax():
    rng = np.random.default_rng(3)
    kw = rng.standard_normal((3, 4, 16)).astype(np.float32)
    emb = rng.standard_normal((40, 16)).astype(np.float32)
    emb[5] = 0.0  # a zero row: the eps clamp
    want = jb.cosine_scores(jnp.asarray(kw), jnp.asarray(emb))
    got = pb.cosine_scores(torch.from_numpy(kw), torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    """JAX ``flagship_tiny_config()`` at f32: the CLIP params and the
    cascaded branch (params, state), carried over."""
    cfg = flagship_tiny_config()
    from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel

    jm = JaxModel(cfg)
    jparams, jstate = jax.jit(jm.init)(jax.random.key(0))
    pparams = speechclip_params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(4)
    bn = jax.tree.map(np.asarray, jstate["cascaded_branch"]["bn"])
    state = {"cascaded_branch": {"bn": {
        "mean": (0.01 * rng.standard_normal(bn["mean"].shape)).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)}}}
    return dict(jm=jm, cfg=cfg, jparams=jparams, pparams=pparams, state=state,
                pcfg=cascaded_config_from_jax(cfg.model_settings.cascaded_branch),
                feat=rng.standard_normal((3, T, 32)).astype(np.float32))


def _text_cfg(tiny):
    return port_config.CLIPTextConfig(**dataclasses.asdict(tiny["jm"].clip_cfg.text))


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_keywords_is_encode_text_on_the_full_buffer(tiny, dtype):
    """K keyword embeddings at K + 2 tokens give what the full 77-token
    buffer [SOT, ids, EOT, 0 ...] gives at its EOT, in the port (f32:
    1e-5) and against JAX's ``encode_keywords``."""
    jm, jparams = tiny["jm"], tiny["jparams"]
    cfg = _text_cfg(tiny)
    params = cast_params({"text": tiny["pparams"]["clip"]["text"]}, dtype, device="cpu")
    k = 4
    ids = np.array([[5, 9, 11, 7], [1, 1, 40, 60], [8, 20, 30, 50]], np.int64)
    kw = params["text"]["token_embedding"][torch.from_numpy(ids)].to(dtype)
    got = pclip.encode_keywords(params, cfg, kw, jm.sot_id, jm.eot_id)
    want = jclip.encode_keywords(jparams["clip"], jm.clip_cfg,
                                 jnp.asarray(kw.float().numpy()).astype(_jdt(dtype)),
                                 jm.sot_id, jm.eot_id)
    assert got.shape == (3, 16) and got.dtype == dtype
    assert_match(got, want, dtype)
    if dtype == torch.float32:
        buf = np.zeros((3, 77), np.int64)
        buf[:, 0], buf[:, 1:k + 1], buf[:, k + 1] = jm.sot_id, ids, jm.eot_id
        full = pclip.encode_text(params, cfg, torch.from_numpy(buf),
                                 torch.full((3,), k + 1))
        torch.testing.assert_close(got, full, rtol=0, atol=1e-5)
        jfull = jclip.encode_text(jparams["clip"], jm.clip_cfg, jnp.asarray(buf),
                                  jnp.full((3,), k + 1))
        assert_match(full, jfull, dtype)


def test_reduced_vocab_matches_jax():
    path = str(REPO_ROOT / port_config.FLICKR_VOCAB)
    pv, jv = pclip.load_reduced_vocab(path), jclip.load_reduced_vocab(path)
    assert pv.size == jv.size == 8112
    np.testing.assert_array_equal(pv.selected_ids, jv.selected_ids)
    np.testing.assert_allclose(pv.freq_dist, jv.freq_dist)
    assert pv.original_to_reduced == jv.original_to_reduced
    ids = jv.selected_ids[[0, 5, 8000]]
    np.testing.assert_array_equal(pv.map_original(ids), jv.map_original(ids))
    np.testing.assert_array_equal(pv.map_reduced(np.array([3, 7])), jv.map_reduced(np.array([3, 7])))
    with pytest.raises(KeyError):
        pv.map_original(np.array([1]))  # id 1 is not in the Flickr table
    table = torch.arange(49408.0)[:, None].expand(49408, 2)
    cut = pclip.reduce_token_embedding({"text": {"token_embedding": table}}, pv)
    np.testing.assert_array_equal(cut["text"]["token_embedding"][:, 0].numpy(), pv.selected_ids)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cascaded_branch_apply_matches_jax(tiny, dtype):
    jm, cb = tiny["jm"], tiny["cfg"].model_settings.cascaded_branch
    jp = tiny["jparams"]
    want_feat, want_vq, want_kw, _ = jax.jit(
        lambda p, s, f, l: jb.cascaded_branch_apply(
            p["cascaded_branch"], s, cb, p["clip"], jm.clip_cfg, jm.sot_id, jm.eot_id, f, l)
    )(jp, jax.tree.map(jnp.asarray, tiny["state"]["cascaded_branch"]),
      jnp.asarray(tiny["feat"]).astype(_jdt(dtype)), jnp.asarray(LENS))
    pp = cast_params(tiny["pparams"], dtype, device="cpu")
    ps = cast_params(_tensors(tiny["state"]), dtype, device="cpu")
    feat, vq, kw, _ = pb.cascaded_branch_apply(
        pp["cascaded_branch"], ps["cascaded_branch"], tiny["pcfg"], pp["clip"], _text_cfg(tiny),
        jm.sot_id, jm.eot_id, torch.from_numpy(tiny["feat"]).to(dtype), torch.from_numpy(LENS))
    assert feat.shape == (3, 16) and kw.shape == (3, 4, 32) and kw.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_array_equal(vq["targets"].numpy(), np.asarray(want_vq["targets"]))
        np.testing.assert_allclose(kw.numpy(), np.asarray(want_kw), atol=1e-6)
    assert_match(feat, want_feat, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pre_vq_keywords_hidden_states_and_attention_map_match_jax(tiny, dtype):
    cb = tiny["cfg"].model_settings.cascaded_branch
    jp = tiny["jparams"]["cascaded_branch"]
    f, l = jnp.asarray(tiny["feat"]).astype(_jdt(dtype)), jnp.asarray(LENS)
    pp = cast_params(tiny["pparams"]["cascaded_branch"], dtype, device="cpu")
    ps = cast_params(_tensors(tiny["state"]["cascaded_branch"]), dtype, device="cpu")
    pf, plens = torch.from_numpy(tiny["feat"]).to(dtype), torch.from_numpy(LENS)
    js = jax.tree.map(jnp.asarray, tiny["state"]["cascaded_branch"])
    assert_match(pb.project_keywords_for_visualization(pp, ps, tiny["pcfg"], pf, plens),
                 jb.project_keywords_for_visualization(jp, js, cb, f, l), dtype)
    got_h = pb.cascaded_branch_hidden_states(pp, tiny["pcfg"], pf, plens)
    want_h = jb.cascaded_branch_hidden_states(jp, cb, f, l)
    assert len(got_h) == len(want_h) == 2
    for g, w in zip(got_h, want_h):
        assert g.shape == (3, T, 32)
        assert_match(g, w, dtype)
    got_w = pb.cascaded_branch_attention_map(pp, tiny["pcfg"], pf, plens)
    want_w = jb.cascaded_branch_attention_map(jp, cb, f, l)
    assert got_w.shape == (3, 1, 4, T + 4)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w, np.float32),
                               atol=1e-5 if dtype == torch.float32 else 2e-3)


# one full-width cascaded MHA-and-norm (D = 768, one head, T + K = 60 rows)
# and one full-width CLIP text layer (width 512, 8 heads, causal, K + 2 rows)
@pytest.fixture(scope="module")
def wide_layers():
    rng = np.random.default_rng(5)
    d, t = 768, 60
    jmn = jtr.mha_and_norm_init(jax.random.key(6), d)
    jblock = jclip._block_init(jax.random.key(7), 512, 2048)
    return dict(jmn=jmn, pmn=_tensors(jmn), jblock=jblock, pblock=_tensors(jblock),
                src=rng.standard_normal((2, t, d)).astype(np.float32),
                lens=np.array([t, 35], np.int32),
                text=rng.standard_normal((2, 10, 512)).astype(np.float32))


@pytest.fixture
def jax_on_one_tpu(monkeypatch):
    """JAX dispatches its Pallas kernels (interpret mode) as on one TPU;
    yields the names of the attention kernels it called."""
    called = []
    real = jfa.flash_attention
    monkeypatch.setattr(jfa, "flash_attention",
                        lambda *a, **k: called.append("flash_attention") or real(*a, **k))
    monkeypatch.setattr(jattn, "_on_tpu", lambda: True)
    with jattn.kernel_mesh(jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))):
        yield called


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_full_width_mha_and_norm_matches_jax(wide_layers, jax_on_one_tpu, backend, dtype):
    w = wide_layers
    src, lens = w["src"], w["lens"]
    kpm = np.arange(src.shape[1])[None, :] >= lens[:, None]
    with jattn.attention_backend(backend):
        want, _ = jtr.mha_and_norm_apply(
            w["jmn"], jnp.asarray(src).astype(_jdt(dtype)), nhead=1,
            key_padding_mask=jnp.asarray(kpm), key_valid_lens=jnp.asarray(lens))
    with pattn.attention_backend(backend):
        got, _ = ptr.mha_and_norm_apply(
            cast_params(w["pmn"], dtype, device="cpu"), torch.from_numpy(src).to(dtype), nhead=1,
            key_padding_mask=torch.from_numpy(kpm), key_valid_lens=torch.from_numpy(lens))
    assert jax_on_one_tpu == (["flash_attention"] if backend == "pallas" else [])
    assert got.dtype == dtype
    assert_match(got, want, dtype)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_full_width_text_layer_matches_jax(wide_layers, jax_on_one_tpu, backend, dtype):
    w = wide_layers
    with jattn.attention_backend(backend):
        want = jclip._resblock(w["jblock"], jnp.asarray(w["text"]).astype(_jdt(dtype)), 8, True)
    with pattn.attention_backend(backend):
        got = pclip._resblock(cast_params(w["pblock"], dtype, device="cpu"),
                              torch.from_numpy(w["text"]).to(dtype), 8, True)
    assert jax_on_one_tpu == (["flash_attention"] if backend == "pallas" else [])
    assert_match(got, want, dtype)


def test_route_table_of_the_cascaded_layers_at_base_width():
    """The 768-wide head (T + K = 327 rows at 6.4 s, 857 at 17 s) goes to
    ``sdpa_plain`` under "auto" (``block_eligible`` and ``vmem_eligible``
    need Dh <= 128) and to ``flash_attention`` under "pallas"; so do the
    text tower's causal K + 2 = 10 rows (under both kernel gates' L*S)."""
    from speechclip_tpu_torch.kernels.fused_layer import fused_mha_and_norm

    for b in (16, 64, 256):
        for t in (327, 600, 857):
            assert pattn.attention_route(b, t, t, 768, 1, 2) == "sdpa"
            assert pattn.attention_route(b, t, t, 768, 1, 2, backend="pallas") == "flash_attention"
        assert pattn.attention_route(b, 10, 10, 512, 8, 2, causal=True) == "sdpa"
        assert pattn.attention_route(b, 10, 10, 512, 8, 2, causal=True,
                                     backend="pallas") == "flash_attention"
    x = torch.zeros(2, 327, 768, dtype=torch.bfloat16)
    p = {"attn": ptr.mha_init(torch.Generator(), 768), "norm": {"scale": None, "bias": None}}
    assert fused_mha_and_norm(x, None, heads=1, eps=1e-5, attn=p["attn"],
                                  norm=p["norm"]) is None
