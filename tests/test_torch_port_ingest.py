"""The port's data path (repmode_tpu_torch.native, data.czi, data.transforms,
data.csv_tools, data.ingest, data.store, data.sampler) against the JAX
package's on the same files and numpy inputs, on the CPU.

The CZI files come from ``tests/test_czi.py::write_czi`` (compression 0, and
2 through the libtiff-verified ``tests/lzw_ref.py`` encoder); the CSVs are
the repo's ``data/csvs/*.csv`` and ones pandas writes. Arrays, CSV files and
manifests are held bit- or byte-equal; nothing here has a tolerance.
"""

import glob
import json
import math
import os
import struct

import numpy as np
import pandas as pd
import pytest
import torch

from repmode_tpu import native as jax_native
from repmode_tpu.config import Config as JaxConfig
from repmode_tpu.config import DataConfig as JaxDataConfig
from repmode_tpu.data import csv_tools as jax_csv
from repmode_tpu.data import transforms as jax_tf
from repmode_tpu.data.czi import CziFile as JaxCziFile
from repmode_tpu.data.czi import CziVolumeReader as JaxCziVolumeReader
from repmode_tpu.data.ingest import ingest_split as jax_ingest_split
from repmode_tpu.data.ingest import load_split_dataframe as jax_load_split
from repmode_tpu.data.sampler import PatchSampler as JaxPatchSampler
from repmode_tpu.data.sampler import apply_crop_flip
from repmode_tpu.data.store import VolumeRecord as JaxVolumeRecord
from repmode_tpu.data.store import VolumeStore as JaxVolumeStore
from repmode_tpu.data.synthetic import synthetic_store as jax_synthetic_store
from repmode_tpu_torch import native
from repmode_tpu_torch.config import Config, DataConfig
from repmode_tpu_torch.data import csv_tools
from repmode_tpu_torch.data import transforms as tf
from repmode_tpu_torch.data.czi import CziFile, CziVolumeReader
from repmode_tpu_torch.data.ingest import ingest_split, load_split_dataframe
from repmode_tpu_torch.data.sampler import PatchSampler
from repmode_tpu_torch.data.store import VolumeStore
from repmode_tpu_torch.data.synthetic import synthetic_store
from tests.lzw_ref import tiff_lzw_encode
from tests.test_czi import write_czi

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_CSVS = sorted(glob.glob(os.path.join(REPO, "data", "csvs", "*.csv")))


def same_value(a, b) -> bool:
    """Equal, NaN equal to NaN."""
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, (float, np.floating)) and math.isnan(b)
    return a == b


def assert_rows_match_pandas(rows, df):
    """The port's typed rows against ``dict(df.iloc[i])``: keys in order,
    values equal, and each value's Python type the one pandas' dtype gives."""
    assert len(rows) == len(df)
    for i, row in enumerate(rows):
        ref = dict(df.iloc[i])
        assert list(row) == list(ref)
        for k, v in ref.items():
            assert same_value(row[k], v), (k, row[k], v)
            kind = df[k].dtype.kind
            want = {"i": int, "f": float, "b": bool}.get(kind)
            if want is not None:
                assert type(row[k]) is want, (k, type(row[k]), df[k].dtype)
            else:
                assert isinstance(row[k], str) or math.isnan(row[k]), (k, row[k])


# ------------------------------------------------------------------ native


@pytest.mark.parametrize("payload", [
    b"", b"A", b"TOBEORNOTTOBEORTOBEORNOT", bytes(range(256)) * 4, b"\x00" * 5000,
    np.random.default_rng(3).integers(0, 16, 20000).astype(np.uint8).tobytes(),
])
def test_lzw_decode_matches_jax(payload):
    enc = tiff_lzw_encode(payload)
    n = max(len(payload), 1)
    assert native.lzw_decode(enc, n) == jax_native.lzw_decode(enc, n) == payload


def test_lzw_decode_malformed_raises_in_both():
    garbage = b"\xff" * 64  # first code 511: beyond the table
    for decode in (native.lzw_decode, jax_native.lzw_decode):
        with pytest.raises(ValueError, match="malformed"):
            decode(garbage, 1024)


def test_crop_flip_batch_matches_jax_and_numpy():
    rng = np.random.default_rng(0)
    patch = (4, 6, 8)
    volumes, starts, flips = [], [], []
    for i in range(6):
        shape = (8 + i, 12, 16)
        volumes.append((rng.standard_normal(shape).astype(np.float32),
                        rng.standard_normal(shape).astype(np.float32)))
        starts.append([rng.integers(0, d - p + 1) for d, p in zip(shape, patch)])
        flips.append(rng.integers(0, 2, 3))
    starts, flips = np.asarray(starts, np.int64), np.asarray(flips, np.uint8)
    sig, tgt = native.crop_flip_batch(volumes, starts, flips, patch)
    jsig, jtgt = jax_native.crop_flip_batch(volumes, starts, flips, patch)
    np.testing.assert_array_equal(sig, jsig)
    np.testing.assert_array_equal(tgt, jtgt)
    for i, (s, t) in enumerate(volumes):
        np.testing.assert_array_equal(sig[i], apply_crop_flip(s, starts[i], flips[i], patch))
        np.testing.assert_array_equal(tgt[i], apply_crop_flip(t, starts[i], flips[i], patch))


def test_crop_flip_batch_refuses_bad_inputs():
    vol = np.zeros((4, 8, 8), np.float32)
    with pytest.raises(ValueError, match="outside"):
        native.crop_flip_batch([(vol, vol)], [[1, 0, 0]], [[0, 0, 0]], (4, 8, 8))
    with pytest.raises(ValueError, match="float32"):
        native.crop_flip_batch([(vol.astype(np.float64), None)], [[0, 0, 0]], [[0, 0, 0]],
                               (4, 8, 8))


def test_native_builds_into_build_dir():
    native.lib()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR == native.Path(REPO) / "build" / "native"


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed build raises with the compiler's output, in the loader and in
    the sampler's native path; nothing falls back to numpy."""
    bad = tmp_path / "patchops.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native build failed.*\n.*\n.*error"):
        native.lib()
    store = synthetic_store(("a",), volumes_per_task=2, vol_shape=(8, 16, 16))
    with pytest.raises(RuntimeError, match="native build failed"):
        PatchSampler(store, 2, (4, 8, 8))
    PatchSampler(store, 2, (4, 8, 8), use_native=False)  # the explicit numpy path


@pytest.mark.parametrize("prefetch", [0, 2])
def test_sampler_paths_match_jax(prefetch):
    """Native and numpy batches are bit-equal to each other and to JAX's
    numpy path, epoch after epoch, ragged tail included."""
    tasks, kw = ("a", "b"), dict(volumes_per_task=3, vol_shape=(8, 16, 16), seed=4)
    args = dict(batch_size=4, patch_size=(4, 8, 8), seed=11, prefetch=prefetch)
    store, jstore = synthetic_store(tasks, **kw), jax_synthetic_store(tasks, **kw)
    nat, npy = PatchSampler(store, **args), PatchSampler(store, use_native=False, **args)
    ref = JaxPatchSampler(jstore, use_native=False, **args)
    assert nat._native is not None and npy._native is None
    for _ in range(2):
        for a, b, r in zip(nat.epoch(), npy.epoch(), ref.epoch(), strict=True):
            for k in ("signal", "target", "task"):
                np.testing.assert_array_equal(a[k], b[k])
                np.testing.assert_array_equal(a[k], r[k])
                assert a[k].dtype == r[k].dtype


# ------------------------------------------------------------------ czi


@pytest.fixture(scope="module")
def czi_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("czi")
    data = np.random.default_rng(1).integers(0, 4000, size=(2, 4, 12, 10)).astype(np.uint16)
    paths = {}
    for comp in (0, 2):
        paths[comp] = str(d / f"c{comp}.czi")
        write_czi(paths[comp], data, compression=comp)
    return paths, data


@pytest.mark.parametrize("compression", [0, 2])
def test_czi_reader_matches_jax(czi_files, compression):
    paths, data = czi_files
    path = paths[compression]
    with CziFile(path) as ours, JaxCziFile(path) as ref:
        assert [e.compression for e in ours.entries] == [compression] * 2
        assert ours.axes == ref.axes == "CZYX0"
        assert ours.shape() == ref.shape() == (2, 4, 12, 10, 1)
        assert ours.metadata_xml() == ref.metadata_xml()
        a = ours.asarray()
        np.testing.assert_array_equal(a, ref.asarray())
        np.testing.assert_array_equal(a[..., 0], data)
        assert a.dtype == np.uint16
    r, jr = CziVolumeReader(path), JaxCziVolumeReader(path)
    for c in range(2):
        np.testing.assert_array_equal(r.get_volume(c), jr.get_volume(c))
        np.testing.assert_array_equal(r.get_volume(c), data[c])
    assert r.get_size("Z") == jr.get_size("Z") == 4
    assert r.get_scales() == jr.get_scales()


def _set_compression(path, value):
    """Rewrite the compression field of every directory entry in place."""
    with CziFile(path) as czi:
        pos, n = czi.directory_position, len(czi.entries)
        dims = [len(e.dimensions) for e in czi.entries]
    with open(path, "r+b") as f:
        off = pos + 32 + 128
        for k in range(n):
            f.seek(off + 18)
            f.write(struct.pack("<i", value))
            off += 32 + 20 * dims[k]


@pytest.mark.parametrize("case,exc", [("garbage_lzw", ValueError),
                                      ("jpeg", NotImplementedError)])
def test_czi_bad_subblocks_raise_in_both(tmp_path, monkeypatch, case, exc):
    path = str(tmp_path / "bad.czi")
    data = np.arange(2 * 2 * 4 * 4, dtype=np.uint16).reshape(2, 2, 4, 4)
    if case == "garbage_lzw":
        import tests.lzw_ref

        monkeypatch.setattr(tests.lzw_ref, "tiff_lzw_encode", lambda raw: b"\xff" * 64)
        write_czi(path, data, compression=2)
    else:
        write_czi(path, data)
        _set_compression(path, 1)  # JPEG
    for cls in (CziFile, JaxCziFile):
        with cls(path) as czi, pytest.raises(exc):
            czi.asarray()


# ------------------------------------------------------------------ transforms


def _transform_cases():
    return [
        ("normalize", lambda m: m.normalize, None),
        ("Resizer", lambda m: m.Resizer((1.0, 0.37241, 0.5)), None),
        ("Padder+", lambda m: m.Padder("+", by=4), "undo"),
        ("Padder_int", lambda m: m.Padder((1, 2, 0), mode="reflect"), "undo"),
        ("Cropper-", lambda m: m.Cropper("-", by=4), "undo"),
        ("Cropper_offsets", lambda m: m.Cropper((1, 2, 3), offset=(0, 1, 2)), "undo"),
        ("Propper+", lambda m: m.Propper("+", by=8), "undo"),
        ("Propper-", lambda m: m.Propper("-", by=8), "undo"),
        ("Capper", lambda m: m.Capper(low=-0.5, hi=0.7), None),
        ("ReflectionPadder3d", lambda m: m.ReflectionPadder3d((1, 2, 3)), None),
    ]


@pytest.mark.parametrize("name,make,undo", _transform_cases(), ids=[c[0] for c in _transform_cases()])
def test_transform_matches_jax(name, make, undo):
    x = np.random.default_rng(5).standard_normal((9, 14, 11))
    ours, ref = make(tf), make(jax_tf)
    y, y_ref = ours(x), ref(x)
    assert y.dtype == y_ref.dtype and y.shape == y_ref.shape
    np.testing.assert_array_equal(y, y_ref)
    if undo:
        np.testing.assert_array_equal(ours.undo_last(y), ref.undo_last(y_ref))


def test_transforms_refuse_bad_specs_as_jax():
    for m in (tf, jax_tf):
        with pytest.raises(ValueError):
            m.ReflectionPadder3d(-1)
        with pytest.raises(ValueError):
            m.Padder("x")(np.zeros((4, 4, 4)))
        with pytest.raises(ValueError):
            m.Cropper((1, 1, 1), offset=(0, 0, 9))(np.zeros((4, 4, 4)))


# ------------------------------------------------------------------ csv tools


def test_shuffle_is_pandas_sample_order():
    """pandas' sample(frac=1.0, random_state=RandomState(seed)) draws
    permutation(n): the order the port's shuffle takes."""
    for seed, n in [(42, 80), (0, 1), (7, 720)]:
        df = pd.DataFrame({"i": np.arange(n)})
        ref = df.sample(frac=1.0, random_state=np.random.RandomState(seed))["i"].to_numpy()
        np.testing.assert_array_equal(ref, np.random.RandomState(seed).permutation(n))


@pytest.mark.parametrize("src", DATA_CSVS, ids=[os.path.basename(p) for p in DATA_CSVS])
def test_read_csv_types_match_pandas(src):
    columns, rows = csv_tools.read_csv(src)
    df = pd.read_csv(src)
    assert columns == list(df.columns)
    assert_rows_match_pandas(rows, df)


@pytest.mark.parametrize("src", DATA_CSVS, ids=[os.path.basename(p) for p in DATA_CSVS])
def test_split_dataset_matches_pandas(src, tmp_path):
    """The scripts' cadence (train/test 0.75, then train/val 0.9 of train):
    the same row order as the JAX package's pandas splits, byte-equal files,
    and the keep-existing early return."""
    name = os.path.basename(src)[:-4]
    for pkg, out in ((csv_tools, "p"), (jax_csv, "j")):
        a, b = pkg.split_dataset(src, str(tmp_path / out / "tt"), train_size=0.75)
        pkg.split_dataset(str(tmp_path / out / "tt" / name / "train.csv"),
                          str(tmp_path / out / "tv"), train_size=0.9, names=("train", "val"),
                          name=name)
        if pkg is csv_tools:
            ours = [r["path_czi"] for r in a + b]
        else:
            assert ours == list(a["path_czi"]) + list(b["path_czi"])
        assert pkg.split_dataset(src, str(tmp_path / out / "tt"), train_size=0.75) is None
    for sub in ("tt/{n}/train.csv", "tt/{n}/test.csv", "tv/{n}/train.csv", "tv/{n}/val.csv"):
        rel = sub.format(n=name)
        assert (tmp_path / "p" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes(), rel


@pytest.mark.parametrize("train_size", [0, 5, 0.5])
def test_split_dataset_sizes_match_pandas(tmp_path, train_size):
    src = DATA_CSVS[0]
    ours = csv_tools.split_dataset(src, str(tmp_path / "p"), train_size=train_size, seed=3)
    ref = jax_csv.split_dataset(src, str(tmp_path / "j"), train_size=train_size, seed=3)
    assert [len(x) for x in ours] == [len(x) for x in ref]
    name = os.path.basename(src)[:-4]
    for n in ("train", "test"):
        assert ((tmp_path / "p" / name / f"{n}.csv").read_bytes()
                == (tmp_path / "j" / name / f"{n}.csv").read_bytes())


@pytest.mark.parametrize("ds_type", ["train", "val", "test"])
def test_make_sampled_dataset_matches_pandas(tmp_path, ds_type):
    """The dna task sampled from the other tasks' splits (make_dataset.py),
    as scripts/dataset/*.sh drive it: byte-equal files."""
    used = [os.path.basename(p)[:-4] for p in DATA_CSVS if not p.endswith("dna.csv")]
    dna = os.path.join(REPO, "data", "csvs", "dna.csv")
    for pkg, out in ((csv_tools, "p"), (jax_csv, "j")):
        for src in DATA_CSVS:
            name = os.path.basename(src)[:-4]
            if name == "dna":
                continue
            pkg.split_dataset(src, str(tmp_path / out / "tt"), train_size=0.75)
            pkg.split_dataset(str(tmp_path / out / "tt" / name / "train.csv"),
                              str(tmp_path / out / "s"), train_size=0.9,
                              names=("train", "val"), name=name)
            os.replace(tmp_path / out / "tt" / name / "test.csv",
                       tmp_path / out / "s" / name / "test.csv")
        n = {"train": 54, "val": 6, "test": 20}[ds_type]
        got = pkg.make_sampled_dataset(str(tmp_path / out / "s"), dna, str(tmp_path / out / "d"),
                                       ds_type, used, sample_num=n)
        assert len(got) == n
        assert pkg.make_sampled_dataset(str(tmp_path / out / "s"), dna,
                                        str(tmp_path / out / "d"), ds_type, used) is None
    rel = os.path.join("d", "dna", f"{ds_type}.csv")
    assert (tmp_path / "p" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes()


# ------------------------------------------------------------------ ingest and store


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Two tasks; train/val/test CSVs written by pandas in the reference schema
    with 'data'-prefixed paths; an LZW-compressed CZI; an unlabeled test row
    (empty channel_target); a task whose train CSV has an extra column."""
    root = tmp_path_factory.mktemp("ds")
    rng = np.random.default_rng(2)
    czis = {}
    os.makedirs(root / "czi")
    for k, comp in enumerate([0, 2, 0]):
        data = rng.integers(0, 4000, size=(2, 4, 30, 28)).astype(np.uint16)
        name = f"img_{k}.czi"
        write_czi(str(root / "czi" / name), data, compression=comp)
        czis[name] = data
    layout = {
        "train": {"dna": [("img_0", 0, 1), ("img_1", 1, 0)], "lamin_b1": [("img_2", 0, 1)]},
        "val": {"dna": [("img_2", 1, 0)], "lamin_b1": [("img_1", 0, 1)]},
        "test": {"dna": [("img_1", 0, 1), ("img_0", 1, None)], "lamin_b1": [("img_0", 0, 1)]},
    }
    for split, tasks in layout.items():
        for ds, rows in tasks.items():
            df = pd.DataFrame([{
                "path_czi": f"data/{img}.czi", "channel_signal": s,
                "channel_target": np.nan if t is None else t,
                "structureProteinName": ds, "colony_position": "" if s else "edge"}
                for img, s, t in rows])
            if split == "train" and ds == "lamin_b1":
                df["extra"] = 1.5
            os.makedirs(root / "csvs" / ds, exist_ok=True)
            df.to_csv(root / "csvs" / ds / f"{split}.csv", index=False)
    return root, czis


def configs(root, workers=1):
    kw = dict(adopted_datasets=("dna", "lamin_b1"), path_dataset_csv=str(root / "csvs"),
              path_dataset_czi=str(root / "czi"), num_workers=workers)
    return Config(data=DataConfig(**kw)), JaxConfig(data=JaxDataConfig(**kw))


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_split_rows_match_pandas(dataset, split):
    cfg, jcfg = configs(dataset[0])
    assert_rows_match_pandas(load_split_dataframe(cfg, split), jax_load_split(jcfg, split))


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("split", ["train", "test"])
def test_ingest_split_matches_jax(dataset, split, workers):
    """Serial and threaded ingest: arrays bit-equal to JAX's serial ingest,
    info equal to JAX's dict(row), an unlabeled row without a target."""
    cfg, jcfg = configs(dataset[0], workers)
    ours, ref = ingest_split(cfg, split), jax_ingest_split(configs(dataset[0])[1], split)
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours.records, ref.records):
        assert (a.dataset, a.task) == (b.dataset, b.task)
        assert a.task == cfg.task_index(a.dataset)
        assert a.signal.dtype == np.float32 and a.signal.shape == (4, 11, 10)
        np.testing.assert_array_equal(a.signal, b.signal)
        if b.target is None:
            assert a.target is None and math.isnan(a.info["channel_target"])
        else:
            np.testing.assert_array_equal(a.target, b.target)
        assert list(a.info) == list(b.info)
        assert all(same_value(a.info[k], v) for k, v in b.info.items())
        assert type(a.info["channel_signal"]) is int and isinstance(a.info["path_czi"], str)


def test_ingest_reads_lzw_czi_as_raw(dataset):
    """The LZW-compressed image ingests to the z-score + zoom of its raw data."""
    root, czis = dataset
    cfg, _ = configs(root)
    rec = next(r for r in ingest_split(cfg, "train").records
               if r.info["path_czi"] == "data/img_1.czi")
    raw = czis["img_1.czi"][1].astype(np.float64)
    ref = tf.Resizer(cfg.data.resize_factors)((raw - raw.mean()) / raw.std())
    np.testing.assert_array_equal(rec.signal, ref.astype(np.float32))


def test_store_save_load_across_packages(dataset, tmp_path):
    """The port's manifest is byte-equal to JAX's for the same records; each
    package loads the other's split with equal arrays and info; filtering,
    get_information and task_index as in JAX."""
    cfg, _ = configs(dataset[0])
    store = ingest_split(cfg, "test")
    jstore = JaxVolumeStore([JaxVolumeRecord(**vars(r)) for r in store.records],
                            store.adopted_datasets)
    store.save(str(tmp_path / "p"), "test")
    jstore.save(str(tmp_path / "j"), "test")
    assert ((tmp_path / "p" / "test.manifest.json").read_bytes()
            == (tmp_path / "j" / "test.manifest.json").read_bytes())
    manifest = json.loads((tmp_path / "p" / "test.manifest.json").read_text())
    assert math.isnan(manifest["volumes"][1]["info"]["channel_target"])
    for loaded in (JaxVolumeStore.load(str(tmp_path / "p"), "test"),
                   VolumeStore.load(str(tmp_path / "j"), "test")):
        assert loaded.adopted_datasets == store.adopted_datasets
        for a, b in zip(loaded.records, store.records, strict=True):
            np.testing.assert_array_equal(a.signal, b.signal)
            assert (a.target is None) == (b.target is None)
            if b.target is not None:
                np.testing.assert_array_equal(a.target, b.target)
            assert all(same_value(a.info[k], v) for k, v in b.info.items())
    only = store.filter_datasets(["lamin_b1"])
    ref_only = jstore.filter_datasets(["lamin_b1"])
    assert [r.info["path_czi"] for r in only.records] == [r.info["path_czi"]
                                                           for r in ref_only.records]
    assert only.adopted_datasets == store.adopted_datasets
    assert store.get_information(2) is store.records[2].info
    assert store.get_information(2) == jstore.get_information(2)
    assert [cfg.task_index(d) for d in cfg.data.adopted_datasets] == [0, 1]
    with pytest.raises(ValueError):
        cfg.task_index("zo1")


def test_store_loads_jax_synthetic_manifest(tmp_path):
    kw = dict(volumes_per_task=2, vol_shape=(8, 12, 12), seed=1)
    jax_synthetic_store(("a", "b", "c"), **kw).save(str(tmp_path), "val")
    ours = VolumeStore.load(str(tmp_path), "val", ("b",))
    ref = JaxVolumeStore.load(str(tmp_path), "val", ("b",))
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours.records, ref.records):
        np.testing.assert_array_equal(a.signal, b.signal)
        assert (a.task, a.dataset, a.info) == (b.task, b.dataset, b.info)


# ------------------------------------------------------------------ chip_smoke's data writer


@pytest.mark.parametrize("compression", [0, 2])
def test_chip_smoke_czi_writer_matches_tests_writer(tmp_path, compression):
    """chip_smoke.py writes its CZIs (and LZW-encodes them) without this
    directory's helpers: its files are byte-equal to tests/test_czi.py's,
    whose LZW encoder is pinned to libtiff (tests/test_native.py)."""
    import chip_smoke

    for payload in (b"", b"TOBEORNOTTOBEORTOBEORNOT", bytes(range(256)) * 40,
                    np.random.default_rng(8).integers(0, 7, 30000).astype(np.uint8).tobytes()):
        assert chip_smoke.lzw_encode(payload) == tiff_lzw_encode(payload)
    data = np.random.default_rng(9).integers(0, 4000, size=(2, 3, 9, 7)).astype(np.uint16)
    chip_smoke.write_czi(str(tmp_path / "smoke.czi"), data, compression=compression)
    write_czi(str(tmp_path / "tests.czi"), data, compression=compression)
    assert (tmp_path / "smoke.czi").read_bytes() == (tmp_path / "tests.czi").read_bytes()
