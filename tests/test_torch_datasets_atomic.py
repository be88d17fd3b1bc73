"""The pair-id map ``Flickr8k_idPairs.json`` appears whole or not at all:
``_generate_id_pairs`` writes it to a temporary file beside it and renames
that onto the name, so a rank of a data-parallel world that builds the same
dataset while another rank writes the map never reads a partial file."""

import json
import os
import threading

import pytest

from speechclip_tpu_torch.data import datasets as port_datasets

NAMES = [f"img{i:04d}" for i in range(400)]
ID_PAIRS = "Flickr8k_idPairs.json"


def test_the_final_file_is_not_visible_while_the_map_is_written(tmp_path, monkeypatch):
    real_dump = json.dump
    seen = []

    def dump(obj, f, **kw):
        seen.append(os.path.exists(tmp_path / ID_PAIRS))
        return real_dump(obj, f, **kw)

    monkeypatch.setattr(port_datasets.json, "dump", dump)
    payload = port_datasets._generate_id_pairs(str(tmp_path), NAMES)
    assert seen == [False]
    assert json.loads((tmp_path / ID_PAIRS).read_text())["filename2Id"] == payload["filename2Id"]
    assert sorted(os.listdir(tmp_path)) == [ID_PAIRS]  # no temporary file left


@pytest.mark.parametrize("existing", [False, True], ids=["fresh", "overwrite"])
def test_a_concurrent_reader_never_sees_a_partial_file(tmp_path, monkeypatch, existing):
    """The writer stops half way through its text while a reader thread
    opens the map's path: the reader finds no file (or the previous whole
    one), and after the write the whole new map."""
    if existing:
        port_datasets._generate_id_pairs(str(tmp_path), NAMES[:3])
    half_written, read_done = threading.Event(), threading.Event()
    reads = []

    def dump(obj, f, **kw):
        text = json.dumps(obj, **kw)
        f.write(text[:len(text) // 2])
        f.flush()
        half_written.set()
        assert read_done.wait(30)
        f.write(text[len(text) // 2:])

    def reader():
        assert half_written.wait(30)
        try:
            with open(tmp_path / ID_PAIRS) as f:
                reads.append(json.load(f))
        except FileNotFoundError:
            reads.append(None)
        finally:
            read_done.set()

    monkeypatch.setattr(port_datasets.json, "dump", dump)
    thread = threading.Thread(target=reader)
    thread.start()
    payload = port_datasets._generate_id_pairs(str(tmp_path), NAMES)
    thread.join(30)
    assert len(reads) == 1
    if existing:
        assert len(reads[0]["filename2Id"]) == 3  # the previous map, whole
    else:
        assert reads[0] is None
    with open(tmp_path / ID_PAIRS) as f:
        assert json.load(f)["filename2Id"] == payload["filename2Id"]


def test_an_unwritable_directory_keeps_the_ids_in_memory(tmp_path):
    missing = tmp_path / "absent"
    payload = port_datasets._generate_id_pairs(str(missing), NAMES[:5])
    assert payload["filename2Id"] == {n: i for i, n in enumerate(NAMES[:5])}
    assert not missing.exists()
