"""The port's orbax reader (``weights/orbax_read.py``) against tensorstore
and the JAX package.

Tensorstore is the oracle of the OCDBT layer only, here in the tests: stores
it writes with small nodes, small inline values and a version tree of arity
4 over hundreds of commits (interior B+tree nodes, version-tree nodes,
indirect values) must list and read key for key as tensorstore does, with
and without zstd.  The JAX package's ``save_checkpoint`` / ``load_checkpoint``
are the oracle of the trees: a small tree of every handled dtype, the
trainers' ``step_N`` layout, and the three committed trained trees, leaf for
leaf and bit for bit.  ``SOMPipeline``'s ``'auto'`` then builds the same
networks as an ``.npz`` written from JAX's restore.
"""

import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from omniparser_tpu_torch.weights import checkpoints as tck
from omniparser_tpu_torch.weights.convert import flatten_variables
from omniparser_tpu_torch.weights.orbax_read import (OcdbtStore, crc32c, read_orbax_tree,
                                                     tree_digest)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "omniparser_tpu", "weights")
TREES = {"det_synth": 297, "ocr_en_synth": 115, "cap_synth": 306}
SMALL_NODES = {"max_decoded_node_bytes": 512, "max_inline_value_bytes": 16,
               "version_tree_arity_log2": 2}


def _jax_restore(path):
    from omniparser_tpu.weights.checkpoints import load_checkpoint

    return load_checkpoint(path)


def _leaves_equal(got, want):
    got, want = flatten_variables(got), flatten_variables(want)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(want[k]), got[k]
        assert (a.dtype, a.shape) == (b.dtype, b.shape), k
        assert a.tobytes() == b.tobytes(), k
    return len(want)


# ------------------------------------------------------------------ OCDBT


def _tensorstore_db(path, compression):
    ts = pytest.importorskip("tensorstore")
    spec = {"driver": "ocdbt", "base": f"file://{path}/",
            "config": {**SMALL_NODES, "compression": compression}}
    kv = ts.KvStore.open(spec).result()
    rng = np.random.default_rng(11)
    written = []
    for i in range(320):  # one commit each: writes, overwrites and deletes
        if i % 41 == 40:
            kv.write(written.pop(int(rng.integers(0, len(written)))), None).result()
            continue
        key = f"grp{i % 7}/leaf.{int(rng.integers(0, 90)):03d}/{'x' * int(rng.integers(0, 5))}"
        kv.write(key, rng.integers(0, 256, int(rng.integers(0, 70)),
                                   dtype=np.uint8).tobytes()).result()
        if key not in written:
            written.append(key)
    return kv


@pytest.mark.parametrize("compression", [None, {"id": "zstd"}], ids=["none", "zstd"])
def test_tensorstore_stores_read_key_for_key(tmp_path, compression):
    kv = _tensorstore_db(tmp_path, compression)
    store = OcdbtStore(str(tmp_path))
    keys = kv.list().result()
    assert store.keys() == sorted(keys) and len(keys) > 100
    assert store.version.generation > 300 and store.version.root_height >= 2
    for k in keys:
        assert store.read(k) == kv.read(k).result().value, k
    assert store.read(b"no/such/key") is None
    # older generations live in version-tree nodes, long values in data files
    assert store.version_nodes >= 4
    indirect = [v for v in store.entries().values() if not isinstance(v, bytes)]
    assert indirect and all(v.length > SMALL_NODES["max_inline_value_bytes"] for v in indirect)


def test_crc32c_known_value():
    assert crc32c(b"123456789") == 0xE3069283  # the Castagnoli check value
    assert crc32c(b"") == 0


def test_corrupt_store_files_raise(tmp_path):
    """A wrong CRC, a flipped magic, a length that disagrees with the file
    and an unknown compression each raise ValueError."""
    src = os.path.join(WEIGHTS, "det_synth")

    def fresh(name):
        dst = tmp_path / name
        shutil.copytree(src, dst)
        return dst

    def poke(path, pos, value):
        data = bytearray(path.read_bytes())
        data[pos] = value
        path.write_bytes(bytes(data))

    d = fresh("crc")
    poke(d / "manifest.ocdbt", -1, (d / "manifest.ocdbt").read_bytes()[-1] ^ 0x01)
    with pytest.raises(ValueError, match="CRC-32C"):
        OcdbtStore(str(d))
    d = fresh("magic")
    poke(d / "manifest.ocdbt", 0, 0x0D)
    with pytest.raises(ValueError, match="magic"):
        OcdbtStore(str(d))
    d = fresh("length")
    with open(d / "manifest.ocdbt", "ab") as f:
        f.write(b"\0")
    with pytest.raises(ValueError, match="header says"):
        OcdbtStore(str(d))
    d = fresh("node")  # the root B+tree node's body, CRC recomputed: zstd refuses it
    root = next(p for p in (d / "d").iterdir())
    data = bytearray(root.read_bytes())
    data[40] ^= 0xFF
    data[-4:] = crc32c(bytes(data[:-4])).to_bytes(4, "little")
    root.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="zstd"):
        read_orbax_tree(str(d))
    d = fresh("compression")
    data = bytearray((d / "manifest.ocdbt").read_bytes())
    data[13] = 7
    data[-4:] = crc32c(bytes(data[:-4])).to_bytes(4, "little")
    (d / "manifest.ocdbt").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="compression 7"):
        OcdbtStore(str(d))


# ------------------------------------------------------------------ trees


def _small_tree():
    import ml_dtypes

    rng = np.random.default_rng(3)
    return {
        "net": {"params": {"dense": {"kernel": rng.standard_normal((3, 5)).astype(np.float32),
                                     "bias": np.zeros(5, np.float32)},
                           "ids": np.arange(7, dtype=np.int32)},
                "mask": {"on": np.array([True, False, True]),
                         "img": rng.integers(0, 255, (2, 3, 4), dtype=np.uint8)}},
        "step": np.array(12, np.int64),
        "scale": np.array(3.5, np.float32),
        "half": rng.standard_normal(5).astype(np.float16),
        "wide": rng.standard_normal((2, 2)),
        "signed": np.array([-3, 4], np.int8),
        "count": np.array([1, 2], np.uint32),
        "dot.name": np.ones(2, np.float32),
        "bf16": rng.standard_normal(6).astype(ml_dtypes.bfloat16),
    }


def test_a_tree_saved_by_the_jax_package_reads_back_equal(tmp_path):
    from omniparser_tpu.weights.checkpoints import save_checkpoint

    tree = _small_tree()
    path = save_checkpoint(str(tmp_path / "small"), tree)
    want = _jax_restore(path)
    got = read_orbax_tree(path)
    # bfloat16 has no numpy dtype in the port: widened to float32, exactly
    assert got["bf16"].dtype == np.float32
    np.testing.assert_array_equal(got.pop("bf16"), np.asarray(want.pop("bf16"), np.float32))
    assert "dot.name" in got and got["step"].shape == () and got["net"]["mask"]["on"].dtype == bool
    assert _leaves_equal(got, want) == 12


def test_the_trainers_step_directories_load_through_load_checkpoint(tmp_path):
    """The JAX trainers' ``step_N/`` layout: JAX's latest_step_dir finds it,
    the port's load_checkpoint reads it."""
    from omniparser_tpu.weights.checkpoints import latest_step_dir, save_checkpoint

    rng = np.random.default_rng(4)
    tree = {"det": {"params": {"conv": {"kernel": rng.standard_normal((3, 3, 4, 8))
                                        .astype(np.float32)}}}}
    for step in (3, 10):
        save_checkpoint(str(tmp_path), tree, step=step)
    path = latest_step_dir(str(tmp_path))
    assert path.endswith("step_10")
    got = tck.load_checkpoint(path)
    assert list(got) == ["det"]
    np.testing.assert_array_equal(got["det"]["params/conv/kernel"],
                                  tree["det"]["params"]["conv"]["kernel"])


def test_unhandled_trees_raise(tmp_path):
    """A key type or value type the reader does not handle raises."""
    src = os.path.join(WEIGHTS, "det_synth")
    for case in ("key_type", "value_type"):
        d = tmp_path / case
        shutil.copytree(src, d)
        meta = json.loads((d / "_METADATA").read_text())
        entry = next(iter(meta["tree_metadata"].values()))
        if case == "key_type":
            entry["key_metadata"][0]["key_type"] = 1
        else:
            entry["value_metadata"]["value_type"] = "scalar"
        (d / "_METADATA").write_text(json.dumps(meta))
        with pytest.raises(ValueError, match="only dict keys|not a stored numpy array"):
            read_orbax_tree(str(d))


@pytest.mark.parametrize("name", list(TREES))
def test_committed_trees_equal_the_jax_restore(name):
    """Every leaf bit for bit, and chip_smoke's digest constants are the
    digests of JAX's restore."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    path = os.path.join(WEIGHTS, name)
    want = _jax_restore(path)
    got = read_orbax_tree(path)
    assert _leaves_equal(got, want) == TREES[name]
    assert tree_digest(want) == chip_smoke.TREE_DIGESTS[name] == tree_digest(got)


def test_a_digest_mismatch_fails_the_card_check(monkeypatch):
    sys.path.insert(0, ROOT)
    import chip_smoke

    monkeypatch.setitem(chip_smoke.TREE_DIGESTS, "ocr_en_synth", "0" * 64)
    with pytest.raises(SystemExit):
        chip_smoke.read_trees()


# ------------------------------------------------------------------ 'auto'


@pytest.fixture(scope="module")
def auto_and_npz(tmp_path_factory):
    """SOMPipeline(PipelineConfig()) through 'auto', and the same config
    with each weight field an .npz written from JAX's restore of the tree
    (the export's path)."""
    from omniparser_tpu_torch.config import PipelineConfig
    from omniparser_tpu_torch.pipeline import SOMPipeline

    tmp = tmp_path_factory.mktemp("npz")
    fields = {}
    for name, field in (("det_synth", "detector_weights"), ("ocr_en_synth", "ocr_weights"),
                        ("cap_synth", "captioner_weights")):
        flat = flatten_variables(_jax_restore(os.path.join(WEIGHTS, name)))
        if name == "cap_synth":
            with open(os.path.join(WEIGHTS, name, "dims.json")) as f:
                flat["__dims__"] = np.asarray(f.read())
        np.savez(tmp / f"{name}.npz", **flat)
        fields[field] = str(tmp / f"{name}.npz")
    auto = SOMPipeline(PipelineConfig(), device="cpu")
    npz = SOMPipeline(dataclasses.replace(PipelineConfig(), **fields), device="cpu")
    return auto, npz


def _states_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
    return len(sa)


@pytest.mark.parametrize("net", ["detector", "ocr", "captioner"])
def test_auto_builds_the_networks_of_the_jax_restore(auto_and_npz, net):
    auto, npz = auto_and_npz
    if net == "detector":
        assert _states_equal(auto.det_module, npz.det_module) > 100
    elif net == "ocr":
        assert _states_equal(auto.ocr.det, npz.ocr.det) > 10
        assert _states_equal(auto.ocr.rec, npz.ocr.rec) > 10
    else:
        assert auto.captioner.dims == npz.captioner.dims
        with open(os.path.join(WEIGHTS, "cap_synth", "dims.json")) as f:
            raw = json.load(f)
        assert list(auto.captioner.dims.patch_prenorm) == raw["patch_prenorm"]
        assert _states_equal(auto.captioner.model, npz.captioner.model) > 100
