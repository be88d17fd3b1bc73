"""The port's presets against the JAX package's, field by field, and the
config/params bridge the other ``test_torch_*`` files share."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from speechclip_tpu.config import flagship_config, flagship_tiny_config
from speechclip_tpu.models import hubert as jax_hubert
from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu_torch import config as port_config
from speechclip_tpu_torch.convert.from_jax import speechclip_params_from_jax
from speechclip_tpu_torch.models.hubert import HubertConfig
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel, cast_params

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


def port_config_from_jax(cfg) -> port_config.SpeechCLIPConfig:
    """The port's config for a JAX ConfigNode (parallel branch only)."""
    jm = JaxModel(cfg)
    ae, ms = cfg.audio_encoder, cfg.model_settings
    ta = ms.parallel_branch.transformer_args
    select = ae.feat_select_idx
    proj = ms.get("parallel_branch_projection")
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
        ),
        parallel_branch_projection=None if proj is None else tuple(proj.dimensions),
        clip_embed_dim=jm.clip_cfg.embed_dim,
        precision=cfg.trainer.precision,
    )


@pytest.fixture(scope="module")
def tiny_models():
    """(JAX params, port model, port params) from ONE jitted JAX init of the
    tiny preset at precision 32: the port's params are the JAX params
    carried over by convert.from_jax."""
    cfg = parallel_only(flagship_tiny_config())
    cfg.trainer.precision = 32
    jparams, _ = jax.jit(JaxModel(cfg).init)(jax.random.key(0))
    pm = SpeechCLIPModel(port_config_from_jax(cfg))
    pparams = cast_params(
        speechclip_params_from_jax(jax.tree.map(np.asarray, jparams)),
        pm.compute_dtype,
    )
    return jparams, pm, pparams


@pytest.mark.parametrize(
    "jax_preset, port_preset",
    [(flagship_config, port_config.base_config),
     (flagship_tiny_config, port_config.tiny_config)],
    ids=["base", "tiny"],
)
def test_presets_match_jax_field_by_field(jax_preset, port_preset):
    want = dataclasses.asdict(port_config_from_jax(parallel_only(jax_preset())))
    got = dataclasses.asdict(port_preset())
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key


def test_base_hubert_is_jax_hubert_base():
    from speechclip_tpu_torch.models.hubert import HUBERT_BASE

    jax_fields = dataclasses.asdict(jax_hubert.HUBERT_BASE)
    assert set(jax_fields) - PORT_HUBERT_FIELDS == TRAINING_ONLY_FIELDS
    assert dataclasses.asdict(HUBERT_BASE) == {
        k: v for k, v in jax_fields.items() if k in PORT_HUBERT_FIELDS
    }


@pytest.mark.parametrize(
    "field, value",
    [("cascaded_objective_weight", 1.0), ("wsum_remat", True),
     ("audio_encoder_type", "s3prl_plus")],
)
def test_out_of_slice_configs_raise(field, value):
    cfg = dataclasses.replace(port_config.tiny_config(), **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SpeechCLIPModel(cfg)


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
    assert "clip" not in pparams and "criterion" not in pparams


def test_cast_params_keeps_vectors_f32(tiny_models):
    _, _, p = tiny_models
    p16 = cast_params(p, torch.bfloat16)
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
    own = pm.init(torch.Generator().manual_seed(0))
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(carried)
