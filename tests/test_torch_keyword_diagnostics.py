"""The keyword diagnostics of the port's trainer against the JAX package's:
a tiny cascaded ``Trainer.fit`` (tests/test_trainer.py's corpus and config
at dropout 0, the tiny merges file's 519-id vocabulary cut to the corpus's
subwords, both packages with their own tokenizer, the port started from
JAX's initial state) writes the same ``detokenizeText/kw_hit_ep*.json``
(equal) and ``keywords_ep*.json`` (gold text and neighbour tokens equal,
scores 1e-5) and logs the same ``kw_hit_rate/kw_*``. The CLI builds the
tokenizer where the merges file is found and warns as JAX does where it is
not; ``run_keyword_diagnostics`` reads ``detokenized_K_neighbors`` and
``retrieve_method`` from the keyword node; gold text keeps id 0 ('!')."""

import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from speechclip_tpu.models.tokenizer import CLIPTokenizer as JaxTokenizer
from speechclip_tpu.tasks import train_kwclip as jax_task
from speechclip_tpu.training.train_step import create_train_state as jax_create_train_state
from speechclip_tpu.training.trainer import Trainer as JaxTrainer
from speechclip_tpu_torch.config import load_config
from speechclip_tpu_torch.data.datasets import FlickrDataset
from speechclip_tpu_torch.data.vocab_stats import compute_vocab_usage, save_vocab_usage
from speechclip_tpu_torch.models.tokenizer import CLIPTokenizer
from speechclip_tpu_torch.tasks import train_kwclip as port_task
from speechclip_tpu_torch.training.evaluation import run_keyword_diagnostics
from speechclip_tpu_torch.training.trainer import Trainer
from tests.test_trainer import corpus, make_tiny_bpe, trainer_config  # noqa: F401 (fixtures)
from tests.torch_trainer_common import carried, comparable_config, read_metrics

torch.set_num_threads(2)
VOCAB = 519  # make_tiny_bpe's ids


@pytest.fixture(scope="module")
def fitted(trainer_config, corpus, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("kw")
    bpe = make_tiny_bpe(tmp / "merges.txt.gz")
    captions = [e["text"] for split in ("train", "dev", "test")
                for e in FlickrDataset(str(corpus), ["text"], split=split).data]
    save_vocab_usage(compute_vocab_usage(captions, CLIPTokenizer(bpe)), str(tmp / "stat"))
    cfg = comparable_config(trainer_config, dev_batch_size=8, cache=False)
    cfg.log_setting.log_detokenize_results = True
    cfg.clip.custom.text.vocab_size = VOCAB
    cfg.clip.reduce_subword_embbedding = str(tmp / "stat" / "text_clip_vocab_usage_byfreq.npy")
    cfg.model_settings.cascaded_branch.keyword.detokenized_K_neighbors = 5
    jt = JaxTrainer(cfg, workdir=str(tmp / "jax"), tokenizer=JaxTokenizer(bpe),
                    devices=[jax.devices()[0]])
    initial = jax_create_train_state(jt.model, jt.tx, jax.random.key(jt.seed))
    jt.fit()
    path = tmp / "cfg.yaml"
    path.write_text(cfg.to_yaml())
    pt = Trainer(load_config(str(path)), workdir=str(tmp / "port"), tokenizer=CLIPTokenizer(bpe),
                 device="cpu")
    params, model_state = carried(initial)
    pt.fit(initial_params=params, initial_model_state=model_state)
    return tmp, pt


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_dumps_and_hit_rates_match_jax(fitted):
    tmp, pt = fitted
    names = sorted(os.listdir(tmp / "jax" / "detokenizeText"))
    assert names == sorted(os.listdir(tmp / "port" / "detokenizeText"))
    assert names == [f"{kind}_ep{e}.json" for kind in ("keywords", "kw_hit") for e in (1, 2, 3)]
    hits = 0
    for name in names:
        got, want = (_read(tmp / side / "detokenizeText" / name) for side in ("port", "jax"))
        if name.startswith("kw_hit"):
            assert got == want and len(got) == 4  # one list of hit ids per keyword
            continue
        assert len(got) == len(want) == 4  # the dev split's pairs
        for g, w in zip(got, want):
            assert g["gold"] == w["gold"] and g["gold"].startswith("the thing number")
            hits += sum(t.replace("</w>", "") in g["gold"].split()
                        for rows in g["neighbors"].values() for t, _ in rows)
            assert g["neighbors"].keys() == w["neighbors"].keys()
            for key, rows in g["neighbors"].items():
                assert [t for t, _ in rows] == [t for t, _ in w["neighbors"][key]]
                assert len(rows) == 5  # detokenized_K_neighbors
                np.testing.assert_allclose([v for _, v in rows],
                                           [v for _, v in w["neighbors"][key]], atol=1e-5)
    assert hits > 0  # some neighbours are gold words: the comparison is not vacuous
    got, want = read_metrics(tmp / "port")["val"], read_metrics(tmp / "jax")["val"]
    keys = [f"kw_hit_rate/kw_{i}" for i in range(4)]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert all(k in g for k in keys)
        np.testing.assert_allclose([g[k] for k in keys], [w[k] for k in keys], rtol=1e-6)
    assert len(pt.loop_stats["diagnostics"]) == 3


def test_diagnostics_read_the_keyword_node(tmp_path):
    """k and the retrieval method come from the node, with JAX's defaults;
    no gold text or no tokenizer: nothing is written."""

    class Model:
        reduced_vocab = None

    tok = CLIPTokenizer(make_tiny_bpe(tmp_path / "m.txt.gz"))
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((VOCAB, 8)).astype(np.float32)
    collected = {"keywords": rng.standard_normal((3, 2, 8)).astype(np.float32),
                 "gold_text": ["the thing", "of in", "er"]}
    for node, k in ((None, 10), ({"detokenized_K_neighbors": 3}, 3),
                    ({"retrieve_method": "pseudo_inverse"}, 10)):
        out = run_keyword_diagnostics(Model(), collected, torch.from_numpy(emb), tok,
                                      str(tmp_path / "d"), 0, node)
        assert set(out) == {"kw_0", "kw_1"}
        records = _read(tmp_path / "d" / "keywords_ep0.json")
        assert len(records[0]["neighbors"]["keyword_0"]) == k
    assert run_keyword_diagnostics(Model(), {"keywords": collected["keywords"]}, emb, tok,
                                   str(tmp_path / "e"), 0) is None
    assert run_keyword_diagnostics(Model(), collected, emb, None, str(tmp_path / "e"), 0) is None
    assert not (tmp_path / "e").exists()


def test_gold_text_keeps_id_zero(tmp_path, trainer_config):  # noqa: F811
    tok = CLIPTokenizer(make_tiny_bpe(tmp_path / "m.txt.gz"))
    trainer = Trainer.__new__(Trainer)
    trainer.tokenizer = tok
    row = tok.tokenize("wow !! the thing")[0]
    assert 0 in tok.encode("wow !! the thing")
    assert trainer._gold_text(row) == tok.decode(tok.encode("wow !! the thing")) == \
        "wow !! the thing "
    assert trainer._gold_text(row[1:]) == trainer._gold_text(row)  # no leading SOT
    assert trainer._gold_text(np.zeros(4, np.int64)) == "!!!!"  # no EOT: the whole row


def test_cli_builds_the_tokenizer_or_warns(tmp_path, monkeypatch, caplog):
    bpe = make_tiny_bpe(tmp_path / "m.txt.gz")
    monkeypatch.setenv("SPEECHCLIP_BPE_PATH", bpe)
    tok = port_task._build_tokenizer()
    assert isinstance(tok, CLIPTokenizer) and tok.vocab_size == VOCAB
    monkeypatch.setenv("SPEECHCLIP_BPE_PATH", str(tmp_path / "missing.txt.gz"))
    from speechclip_tpu_torch.models import tokenizer as port_tok

    monkeypatch.setattr(port_tok, "REPO_ROOT", tmp_path)  # no assets/ merges file there
    with caplog.at_level(logging.WARNING):
        assert port_task._build_tokenizer() is None
        assert jax_task._build_tokenizer(None) is None
    messages = [r.getMessage() for r in caplog.records if "merges file not found" in r.getMessage()]
    assert len(messages) == 2 and messages[0] == messages[1]
