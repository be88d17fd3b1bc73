"""The port's presets against the JAX package's, field by field, and the
config/params bridge the other ``test_torch_*`` files share; the rule that
the entry points run on the card unless asked for the CPU."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

from speechclip_tpu.config import (
    bench_variant_config,
    flagship_config,
    flagship_large_config,
    flagship_tiny_config,
    load_config,
)
from speechclip_tpu.models import clip as jax_clip
from speechclip_tpu.models import hubert as jax_hubert
from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu_torch import config as port_config
from speechclip_tpu_torch.convert.from_jax import (
    speechclip_params_from_jax,
    speechclip_state_from_jax,
)
from speechclip_tpu_torch.models.hubert import HubertConfig
from speechclip_tpu_torch.models.speechclip import REPO_ROOT, SpeechCLIPModel, cast_params

torch.set_num_threads(2)

PORT_HUBERT_FIELDS = {f.name for f in dataclasses.fields(HubertConfig)}
# eval-only port: the JAX HubertConfig fields it leaves out
TRAINING_ONLY_FIELDS = {
    "dropout", "attention_dropout", "activation_dropout", "layerdrop", "remat"
}


def parallel_only(cfg):
    """The slice's topology: the JAX preset with the cascaded branch off."""
    cfg.model_settings.cascaded_objective_weight = 0.0
    return cfg


def _dims(node):
    return None if node is None else tuple(node.dimensions)


def cascaded_config_from_jax(cb) -> port_config.CascadedBranchConfig:
    """The port's cascaded-branch config for JAX's
    ``model_settings.cascaded_branch``."""
    ta, kw, vq = cb.transformer_args, cb.keyword, cb.vq.args
    bn = kw.get("batchnorms")
    std = None if bn is None else bn.get("std_scale", 1.0)
    return port_config.CascadedBranchConfig(
        transformer_type=cb.transformer_type,
        n_layers=ta.get("n_layers", 1),
        d_model=ta.d_model,
        nhead=ta.nhead,
        dim_feedforward=ta.get("dim_feedforward", 3072),
        activation=ta.get("activation", "gelu"),
        layer_norm_eps=ta.get("layer_norm_eps", 1e-5),
        norm_first=ta.get("norm_first", False),
        keyword_number=kw.number,
        kw_projection=_dims(kw.get("kw_projection")),
        batchnorm_type=None if bn is None else bn.type,
        bn_std_scale=1.0 if std is None else (tuple(std) if isinstance(std, list) else std),
        bn_parallel=False if bn is None else bn.get("parallel", False),
        vq_temp=vq.temp,
        use_gumbel=vq.get("use_gumbel", False),
        hard=vq.get("hard", True),
        ground_truth_perplexity=vq.get("groundTruthPerplexity"),
        kw_projection_dropout=(kw.get("kw_projection") or {}).get("dropout", 0.1),
        dropout=ta.get("dropout", 0.0),
        bn_replica_groups=0 if bn is None else bn.get("replica_groups", 0),
    )


def _proj_dropout(node):
    return 0.1 if node is None else node.get("dropout", 0.1)


def training_fields_from_jax(cfg) -> dict:
    """The port's training fields for a JAX ConfigNode: the loss, the
    optimizer and schedule, the clip, accumulation, and which towers train."""
    ae, cl, ms = cfg.audio_encoder, cfg.cl_loss, cfg.model_settings
    args, opt, sched = cl.args, ae.optim, ae.scheduler
    return dict(
        parallel_branch_projection_dropout=_proj_dropout(ms.get("parallel_branch_projection")),
        cascaded_branch_projection_dropout=_proj_dropout(ms.get("cascaded_branch_projection")),
        image_encoder_projection_dropout=_proj_dropout(ms.get("image_encoder_projection")),
        audio_trainable=bool(ae.get("trainable", False)),
        reinit_layers=tuple(ae.get("reinit_layers", []) or []),
        unfreeze_layers=tuple(ae.get("unfreeze_layers", []) or []),
        image_encoder_trainable=bool(cfg.clip.get("image_encoder_trainable", False)),
        text_encoder_trainable=bool(cfg.clip.get("text_encoder_trainable", False)),
        cl_loss=port_config.ContrastiveLossConfig(
            type=cl.type,
            temperature=args.get("temperature", 0.07),
            temperature_trainable=args.get("learnable_temperature",
                                           args.get("temperature_trainable", False)),
            margin=args.get("margin", 0.0), dcl=args.get("dcl", False),
            a2b=args.get("a2b", True), b2a=args.get("b2a", True),
            contrast_mode=args.get("contrast_mode", "all"),
            base_temperature=args.get("base_temperature", 0.07),
        ),
        optim=port_config.OptimizerConfig(
            name=opt.name, lr=float(opt.args.lr),
            weight_decay=float(opt.args.get("weight_decay", 0.0)),
            betas=tuple(opt.args.get("betas", [0.9, 0.999])),
            eps=float(opt.args.get("eps", 1e-8)),
        ),
        scheduler=port_config.SchedulerConfig(**{
            k: sched[k] for k in ("name", "warmup", "max_step", "final_lr") if k in sched}),
        gradient_clip_val=float(cfg.get_path("trainer.gradient_clip_val", 0) or 0),
        accumulate_grad_batches=int(cfg.get_path("trainer.accumulate_grad_batches", 1) or 1),
        retrieval_audio_feat_src=cfg.get_path("retrieval.audio_feat_src"),
        audio_pretrained_path=ae.get("pretrained_path") if ae.get("pretrained", False) else None,
        clip_pretrained_path=cfg.clip.get("pretrained_path"),
    )


def vision_config_from_jax(vision):
    """The port's image-tower config for a JAX ``CLIPConfig.vision``."""
    cls = (port_config.CLIPResNetVisionConfig if isinstance(vision, jax_clip.CLIPResNetVisionConfig)
           else port_config.CLIPVisionConfig)
    return cls(**dataclasses.asdict(vision))


def port_config_from_jax(cfg) -> port_config.SpeechCLIPConfig:
    """The port's config for a JAX ConfigNode: both branches' settings, the
    CLIP towers, the image projection and the reduced vocabulary."""
    jm = JaxModel(cfg)
    ae, ms = cfg.audio_encoder, cfg.model_settings
    ta = ms.parallel_branch.transformer_args
    select = ae.feat_select_idx
    proj = ms.get("parallel_branch_projection")
    text = dataclasses.asdict(jm.clip_cfg.text)
    return port_config.SpeechCLIPConfig(
        audio=HubertConfig(**{
            k: v for k, v in dataclasses.asdict(jm.audio_cfg).items()
            if k in PORT_HUBERT_FIELDS
        }),
        audio_encoder_type=ae.type,
        feat_select_idx=tuple(select) if isinstance(select, (list, tuple)) else select,
        normalize_hiddenstates=bool(ae.get("normalize_hiddenstates", False)),
        normalize_type=ae.get("normalize_type"),
        wsum_remat=bool(ae.get("wsum_remat", False)),
        parallel_objective_weight=ms.parallel_objective_weight,
        cascaded_objective_weight=ms.cascaded_objective_weight,
        parallel_branch=port_config.BranchConfig(
            n_layers=ta.n_layers,
            d_model=ta.d_model,
            nhead=ta.nhead,
            dim_feedforward=ta.dim_feedforward,
            activation=ta.activation,
            layer_norm_eps=ta.layer_norm_eps,
            norm_first=ta.norm_first,
            need_projection=ms.parallel_branch.get("need_projection", True),
            dropout=ta.get("dropout", 0.0),
        ),
        parallel_branch_projection=None if proj is None else tuple(proj.dimensions),
        cascaded_branch=cascaded_config_from_jax(ms.cascaded_branch),
        cascaded_branch_projection=_dims(ms.get("cascaded_branch_projection")),
        clip_text=port_config.CLIPTextConfig(**text),
        clip_vision=vision_config_from_jax(jm.clip_cfg.vision),
        image_encoder_projection=_dims(ms.get("image_encoder_projection")),
        reduce_subword_embedding=cfg.clip.get("reduce_subword_embbedding"),
        clip_embed_dim=jm.clip_cfg.embed_dim,
        precision=cfg.trainer.precision,
        **training_fields_from_jax(cfg),
    )


@pytest.fixture(scope="module")
def tiny_models():
    """(JAX params, port model, port params) from ONE jitted JAX init of the
    tiny preset at precision 32: the port's params are the JAX params
    carried over by convert.from_jax."""
    cfg = parallel_only(flagship_tiny_config())
    cfg.trainer.precision = 32
    jparams, _ = jax.jit(JaxModel(cfg).init)(jax.random.key(0))
    pm = SpeechCLIPModel(port_config_from_jax(cfg), device="cpu")
    pparams = cast_params(
        speechclip_params_from_jax(jax.tree.map(np.asarray, jparams)),
        pm.compute_dtype, device="cpu",
    )
    return jparams, pm, pparams


def shipped_cascaded():
    """``configs/base/spchclp_c.yaml``, as the JAX package loads it."""
    return load_config(str(REPO_ROOT / "configs/base/spchclp_c.yaml"))


@pytest.mark.parametrize(
    "jax_preset, port_preset",
    [(lambda: parallel_only(flagship_config()), port_config.base_config),
     (lambda: parallel_only(flagship_tiny_config()), port_config.tiny_config),
     (lambda: bench_variant_config("base_casc"), port_config.base_cascaded_config),
     (shipped_cascaded, port_config.shipped_cascaded_config),
     (flagship_tiny_config, port_config.tiny_flagship_config),
     (flagship_config, port_config.flagship_config),
     (flagship_large_config, port_config.flagship_large_config)]
    + [(functools.partial(bench_variant_config, v),
        functools.partial(port_config.bench_variant_config, v))
       for v in ("base", "base_par", "large", "large_par", "large_casc")],
    ids=["base", "tiny", "base_casc", "spchclp_c", "tiny_flagship", "flagship", "flagship_large",
         "bench base", "bench base_par", "bench large", "bench large_par", "bench large_casc"],
)
def test_presets_match_jax_field_by_field(jax_preset, port_preset):
    want = dataclasses.asdict(port_config_from_jax(jax_preset()))
    got = dataclasses.asdict(port_preset())
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("name", sorted(jax_clip.NAMED_CONFIGS))
def test_named_clip_towers_match_jax_field_by_field(name):
    want, got = jax_clip.NAMED_CONFIGS[name], port_config.NAMED_CLIP_CONFIGS[name]
    assert type(got.vision).__name__ == type(want.vision).__name__
    assert dataclasses.asdict(got.vision) == dataclasses.asdict(want.vision)
    assert dataclasses.asdict(got.text) == dataclasses.asdict(want.text)
    if name.startswith("RN"):
        assert (got.vision.embed_dim, got.vision.feature_grid) == (
            want.vision.embed_dim, want.vision.feature_grid)
    assert set(port_config.NAMED_CLIP_CONFIGS) == set(jax_clip.NAMED_CONFIGS)


def test_shipped_cascaded_vocabulary_is_the_flickr_table():
    """8112 rows; SOT and EOT map to reduced ids 2 and 3, as in the JAX model."""
    pm = SpeechCLIPModel(port_config.shipped_cascaded_config(), device="cpu")
    jm = JaxModel(shipped_cascaded())
    assert pm.reduced_vocab.size == jm.reduced_vocab.size == 8112
    assert (pm.sot_id, pm.eot_id) == (jm.sot_id, jm.eot_id) == (2, 3)
    np.testing.assert_array_equal(pm.reduced_vocab.selected_ids, jm.reduced_vocab.selected_ids)


def test_base_hubert_is_jax_hubert_base():
    from speechclip_tpu_torch.models.hubert import HUBERT_BASE

    jax_fields = dataclasses.asdict(jax_hubert.HUBERT_BASE)
    assert set(jax_fields) - PORT_HUBERT_FIELDS == TRAINING_ONLY_FIELDS
    assert dataclasses.asdict(HUBERT_BASE) == {
        k: v for k, v in jax_fields.items() if k in PORT_HUBERT_FIELDS
    }


@pytest.mark.parametrize(
    "field, value",
    [("audio_encoder_type", "s3prl_plus"), ("audio_trainable", True),
     ("image_encoder_trainable", True), ("text_encoder_trainable", True)],
)
def test_out_of_slice_configs_raise(field, value):
    cfg = dataclasses.replace(port_config.tiny_config(), **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SpeechCLIPModel(cfg, device="cpu")


@pytest.mark.parametrize("field", ["reinit_layers", "unfreeze_layers"])
def test_selected_layers_need_a_trainable_encoder(field):
    """JAX's guard: selected layers of a frozen encoder would stay frozen."""
    cfg = dataclasses.replace(port_config.tiny_config(), **{field: (1,)})
    with pytest.raises(ValueError, match="audio_trainable"):
        SpeechCLIPModel(cfg, device="cpu")


def test_a_config_with_no_live_branch_raises():
    cfg = dataclasses.replace(port_config.tiny_config(), parallel_objective_weight=0.0)
    with pytest.raises(ValueError, match="no branch"):
        SpeechCLIPModel(cfg, device="cpu")


@pytest.mark.parametrize("entry", ["model", "cast_params"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Without ``device="cpu"`` the model and ``cast_params`` go to the card,
    and raise where there is none: nothing quietly runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "model":
            SpeechCLIPModel(port_config.tiny_config())
        else:
            cast_params({"w": torch.zeros(2, 2)}, torch.bfloat16)
    model = SpeechCLIPModel(port_config.tiny_config(), device="cpu")
    params, _ = model.init(0)
    assert {t.device.type for t in jax.tree.leaves(params)} == {"cpu"}


def test_conv_weights_change_layout_linear_weights_do_not(tiny_models):
    jparams, _, pparams = tiny_models
    jae, pae = jparams["audio_encoder"], pparams["audio_encoder"]
    for jl, pl_ in zip(jae["feature_extractor"], pae["feature_extractor"]):
        np.testing.assert_array_equal(
            np.asarray(jl["w"]).transpose(2, 1, 0), pl_["w"].numpy()
        )
    np.testing.assert_array_equal(
        np.asarray(jae["encoder"]["pos_conv"]["w"]).transpose(2, 1, 0),
        pae["encoder"]["pos_conv"]["w"].numpy(),
    )
    jl0, pl0 = jae["encoder"]["layers"][0], pae["encoder"]["layers"][0]
    np.testing.assert_array_equal(
        np.asarray(jl0["self_attn"]["in_proj"]["w"]), pl0["self_attn"]["in_proj"]["w"].numpy()
    )
    # the CLIP towers come across whatever the branches; a fixed loss
    # temperature is an empty subtree and stays behind
    assert set(pparams["clip"]) == {"visual", "text", "logit_scale"}
    assert "criterion" not in pparams


def test_cast_params_keeps_vectors_f32(tiny_models):
    _, _, p = tiny_models
    p16 = cast_params(p, torch.bfloat16, device="cpu")
    layer = p16["audio_encoder"]["encoder"]["layers"][0]
    assert layer["fc1"]["w"].dtype == torch.bfloat16
    assert layer["fc1"]["b"].dtype == torch.float32
    assert layer["final_layer_norm"]["scale"].dtype == torch.float32
    assert p16["weighted_sum"]["weights"].dtype == torch.float32
    assert p16["parallel_branch"]["cls"].dtype == torch.bfloat16


def test_port_init_shapes_match_jax_init(tiny_models):
    """The port's own seeded init builds the same tree of shapes as the
    JAX init it mirrors (values differ: other generator)."""
    _, pm, carried = tiny_models
    own, state = pm.init(0)
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(carried) and state == {}


@pytest.mark.parametrize("preset", [flagship_tiny_config, shipped_cascaded])
def test_cascaded_init_shapes_match_jax_init(preset):
    """Both branches (tiny) and the shipped cascaded config (reduced
    vocabulary, full width, traced only): the same trees of shapes for
    params and state as the JAX init carried over."""
    cfg = preset()
    jparams, jstate = jax.eval_shape(JaxModel(cfg).init, jax.random.key(0))
    zeros = lambda t: jax.tree.map(lambda a: np.zeros(a.shape, np.float32), t)
    carried = speechclip_params_from_jax(zeros(jparams))
    carried_state = speechclip_state_from_jax(zeros(jstate))
    pm = SpeechCLIPModel(port_config_from_jax(cfg), device="cpu")
    own, state = pm.init(0)
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(carried)
    assert shapes(state) == shapes(carried_state)
    assert set(own["clip"]) == {"visual", "text", "logit_scale"}
