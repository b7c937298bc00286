"""The port's data pipeline (smow_net_tpu_torch/data, runtime) against the
JAX package's on the CPU, with numpy-seeded inputs.

- `data/png.py`'s reader against matplotlib's `imread` (the JAX package's
  reader), bitwise: files PIL writes, and files crafted here that use each
  of PNG's five row filters in every supported colour type and depth. Its
  writer read back by PIL, bitwise.
- `generate_synthetic_dataset` against the JAX package's, pixel for pixel.
- The host engine (`runtime/native.py`, its own copy of augment.cpp plus
  `png_unfilter`) against the JAX package's engine, bitwise on every
  parameter branch; `augment_batch` against `augment_sample`.
- The plain numpy transforms against the engine (1e-5; nearest-rotated
  masks may differ on <= 0.5% of pixels, at .5 ties) and against the JAX
  package's cv2 transforms: flip bitwise, rotate 2e-3 with masks <= 2%
  (the JAX package's own bounds), blur 1e-5.
- `CDDataset.get` and the `DataLoader`'s batches bitwise against the JAX
  package's (its native path).
"""

import struct
import zlib

import numpy as np
import pytest
import torch
from matplotlib.image import imread
from PIL import Image

from smow_net_tpu.data import dataset as jax_dataset
from smow_net_tpu.data import transforms as jax_tf
from smow_net_tpu.runtime import native as jax_native
from smow_net_tpu_torch.data import dataset, png
from smow_net_tpu_torch.data import transforms as tf
from smow_net_tpu_torch.runtime import native


# ---------------------------------------------------------------- PNG files

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(cur, prior, bpp, ftype):
    """PNG's forward filter of one scanline (spec section 9), in ints."""
    cur, prior = cur.astype(np.int64), prior.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
    pred = {0: 0, 1: left, 2: prior, 3: (left + prior) // 2,
            4: _paeth(left, prior, upleft)}[ftype]
    return ((cur - pred) % 256).astype(np.uint8)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _crafted_png(rows, width, depth, ctype, bpp, plte=b"", trns=b"", interlace=0):
    """A PNG whose row y uses filter y % 5 (so every filter runs, and Up,
    Average and Paeth on rows with a real prior row)."""
    prior = np.zeros(rows.shape[1], np.uint8)
    data = b""
    for y, row in enumerate(rows):
        data += bytes([y % 5]) + _filter_row(row, prior, bpp, y % 5).tobytes()
        prior = row
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, rows.shape[0],
                                                      depth, ctype, 0, 0, interlace))
    if plte:
        out += _chunk(b"PLTE", plte)
    if trns:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


# (colour type, bit depth): channels
CRAFTED = {(0, 8): 1, (0, 16): 1, (2, 8): 3, (2, 16): 3, (3, 8): 1, (4, 8): 2,
           (4, 16): 2, (6, 8): 4, (6, 16): 4}


@pytest.mark.parametrize("ctype,depth", list(CRAFTED), ids=lambda v: str(v))
def test_reader_matches_matplotlib_on_every_filter(tmp_path, ctype, depth):
    rng = np.random.default_rng(ctype * 100 + depth)
    h, w, ch = 11, 13, CRAFTED[(ctype, depth)]
    bpp = ch * depth // 8
    rows = rng.integers(0, 256, (h, w * bpp), dtype=np.uint8)
    plte = trns = b""
    if ctype == 3:
        rows = rng.integers(0, 20, (h, w), dtype=np.uint8)
        plte = rng.integers(0, 256, 20 * 3, dtype=np.uint8).tobytes()
        trns = rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
    path = tmp_path / "crafted.png"
    path.write_bytes(_crafted_png(rows, w, depth, ctype, bpp, plte, trns))
    want = imread(str(path))
    got = png.read_png(str(path))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _pil_cases(rng):
    u8 = lambda *s: rng.integers(0, 256, s, dtype=np.uint8)  # noqa: E731
    pal = Image.fromarray(rng.integers(0, 30, (19, 23), dtype=np.uint8), mode="L").convert("P")
    pal.putpalette(rng.integers(0, 256, 90).tolist())
    return {"L": (Image.fromarray(u8(19, 23)), {}),
            "RGB": (Image.fromarray(u8(19, 23, 3)), {}),
            "RGBA": (Image.fromarray(u8(19, 23, 4)), {}),
            "LA": (Image.fromarray(u8(19, 23, 2), mode="LA"), {}),
            "I16": (Image.fromarray(rng.integers(0, 2 ** 16, (19, 23), dtype=np.uint16)), {}),
            "P": (pal, {}),
            "P_trns": (pal, {"transparency": bytes(range(0, 250, 10))}),
            "RGB_big": (Image.fromarray(u8(256, 256, 3)), {})}


def test_reader_matches_matplotlib_on_pil_files(tmp_path):
    for name, (img, kwargs) in _pil_cases(np.random.default_rng(1)).items():
        path = str(tmp_path / f"{name}.png")
        img.save(path, **kwargs)
        want, got = imread(path), png.read_png(path)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _refused():
    rows = np.zeros((4, 4), np.uint8)
    good = _crafted_png(rows, 4, 8, 0, 1)
    bad_filter = (png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 1, 8, 0, 0, 0, 0))
                  + _chunk(b"IDAT", zlib.compress(b"\x07" + bytes(4))) + _chunk(b"IEND", b""))
    return {"interlaced": _crafted_png(rows, 4, 8, 0, 1, interlace=1),
            "bit depth 4": _crafted_png(rows[:, :2], 4, 4, 0, 1),
            "filter type 7": bad_filter,
            "bad CRC": good[:-5] + bytes([good[-5] ^ 1]) + good[-4:],
            "not a PNG": b"GIF89a" + good[6:],
            "cut short": good[:-20]}


@pytest.mark.parametrize("case", list(_refused()))
def test_reader_refuses_what_it_does_not_read(case):
    with pytest.raises(ValueError):
        png.decode_png(_refused()[case])


@pytest.mark.parametrize("channels", [None, 3, 4])
def test_writer_round_trips_through_pil(tmp_path, channels):
    rng = np.random.default_rng(2)
    shape = (21, 17) if channels is None else (21, 17, channels)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "w.png")
    png.write_png(path, x)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), x)
    np.testing.assert_array_equal(png.read_png(path), np.divide(x, 255, dtype=np.float32))


def test_synthetic_dataset_matches_jax(tmp_path):
    ours = dataset.generate_synthetic_dataset(str(tmp_path / "port"), n_train=3, n_val=2,
                                              size=40, seed=5)
    theirs = jax_dataset.generate_synthetic_dataset(str(tmp_path / "jax"), n_train=3,
                                                    n_val=2, size=40, seed=5)
    for split in ("train", "val", "test"):
        lists = [open(f"{root}/list/{split}.txt").read() for root in (ours, theirs)]
        assert lists[0] == lists[1]
        for name in lists[0].split():
            for sub in ("A", "B", "label"):
                got = np.asarray(Image.open(f"{ours}/{sub}/{name}"))
                want = np.asarray(Image.open(f"{theirs}/{sub}/{name}"))
                np.testing.assert_array_equal(got, want, err_msg=f"{sub}/{name}")


# ---------------------------------------------------------------- the engine

def _images(h=33, w=29, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    m = (rng.uniform(size=(h, w)) > 0.5).astype(np.float32)
    return a, b, m


def _params(flip, angle, a_cb, a_blur, b_cb, b_blur):
    return {"flip_d": flip, "angle": angle,
            "a": {"cb": a_cb, "alpha": 1.13, "beta": -0.07, "blur": a_blur},
            "b": {"cb": b_cb, "alpha": 0.85, "beta": 0.11, "blur": b_blur}}


# every branch: each flip code, rotation on and off, brightness-contrast on
# and off, both blur kernels, with and without normalization
BRANCHES = [(flip, angle, cb, blur, norm)
            for flip, angle in ((-2, 0.0), (-1, 3.7), (0, -4.4), (1, 0.0), (-2, 2.05))
            for cb, blur in ((False, 0), (True, 3), (True, 5), (False, 5))
            for norm in (True, False)]


def _run(engine, p, imgs, normalize):
    a, b, m = (x.copy() for x in imgs)
    engine.augment_sample(a, b, m, p["flip_d"], p["angle"],
                          p["a"]["cb"], p["a"]["alpha"], p["a"]["beta"], p["a"]["blur"],
                          p["b"]["cb"], p["b"]["alpha"], p["b"]["beta"], p["b"]["blur"],
                          normalize=normalize)
    return a, b, m


def test_engine_matches_jax_engine_bitwise():
    if not jax_native.available():
        pytest.skip("the JAX package's engine does not build here")
    imgs = _images()
    for flip, angle, cb, blur, norm in BRANCHES:
        p = _params(flip, angle, cb, blur, not cb, 3 if blur == 5 else 0)
        for got, want in zip(_run(native, p, imgs, norm), _run(jax_native, p, imgs, norm)):
            np.testing.assert_array_equal(got, want, err_msg=str((flip, angle, cb, blur, norm)))


def test_augment_batch_matches_augment_sample():
    rng = np.random.default_rng(3)
    params = [tf.sample_params(rng) for _ in range(6)]
    samples = [_images(16, 20, seed=s) for s in range(6)]
    a, b, m = (np.stack([s[i] for s in samples]) for i in range(3))
    native.augment_batch(a, b, m, params)
    for i, (p, imgs) in enumerate(zip(params, samples)):
        for got, want in zip((a[i], b[i], m[i]), _run(native, p, imgs, True)):
            np.testing.assert_array_equal(got, want)


def test_engine_refuses_bad_buffers():
    a, b, m = _images()
    with pytest.raises(ValueError):
        native.augment_sample(a.astype(np.float64), b, m, -2, 0.0, 0, 1, 0, 0, 0, 1, 0, 0)
    with pytest.raises(ValueError):
        native.augment_sample(a[:, ::-1], b, m, -2, 0.0, 0, 1, 0, 0, 0, 1, 0, 0)


def test_plain_transforms_match_the_engine():
    imgs = _images(48, 40)
    for flip, angle, cb, blur, _ in BRANCHES[::2]:
        p = _params(flip, angle, cb, blur, not cb, 3 if blur == 5 else 0)
        a, b, m = _run(native, p, imgs, False)
        pa, pb, pm = tf.apply_params(p, *(x.copy() for x in imgs))
        np.testing.assert_allclose(pa, a, rtol=0, atol=1e-5)
        np.testing.assert_allclose(pb, b, rtol=0, atol=1e-5)
        assert (pm != m).mean() <= 0.005
        a, b, m = _run(native, p, imgs, True)
        np.testing.assert_allclose(tf.imagenet_normalize(pa), a, rtol=0, atol=1e-5)


def test_plain_transforms_match_jax_cv2():
    a, b, m = _images(64, 64)
    for d in (-1, 0, 1):
        np.testing.assert_array_equal(tf._flip(a, d), jax_tf._flip(a, d))
    for angle in (4.2, -3.3):
        np.testing.assert_allclose(tf._rotate(a, angle, False), jax_tf._rotate(a, angle, False),
                                   rtol=0, atol=2e-3)
        assert (tf._rotate(m, angle, True) != jax_tf._rotate(m, angle, True)).mean() < 0.02
    import cv2

    for k in (3, 5):
        np.testing.assert_allclose(tf._blur(a * 1.2 - 0.1, k),
                                   cv2.GaussianBlur(a * 1.2 - 0.1, (k, k), 0), rtol=0, atol=1e-5)
    for seed in range(4):
        got = tf.aberration(np.random.default_rng(seed), a)
        want = jax_tf.aberration(np.random.default_rng(seed), a)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_sample_params_draws_as_jax():
    for seed in range(20):
        assert tf.sample_params(np.random.default_rng(seed)) == \
            jax_tf.sample_params(np.random.default_rng(seed))


# ---------------------------------------------------------------- dataset

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cd"))
    return dataset.generate_synthetic_dataset(root, n_train=7, n_val=3, size=32, seed=1)


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dataset_get_matches_jax(data_root):
    if not jax_native.available():
        pytest.skip("the JAX package's engine does not build here")
    for mode in ("train", "val"):
        ours, theirs = dataset.CDDataset(data_root, mode), jax_dataset.CDDataset(data_root, mode)
        assert ours.names == theirs.names
        for idx in range(len(ours)):
            for epoch in (0, 3):
                _equal(ours.get(idx, epoch), theirs.get(idx, epoch))


@pytest.mark.parametrize("shuffle,shards,drop_last", [
    (True, 1, False), (False, 1, False), (True, 2, False), (True, 1, True)])
def test_loader_batches_match_jax(data_root, shuffle, shards, drop_last):
    if not jax_native.available():
        pytest.skip("the JAX package's engine does not build here")
    for shard in range(shards):
        kw = dict(batch_size=3, shuffle=shuffle, seed=9, num_workers=3, drop_last=drop_last,
                  num_shards=shards, shard_id=shard)
        ours = dataset.DataLoader(dataset.CDDataset(data_root, "train"), **kw)
        theirs = jax_dataset.DataLoader(jax_dataset.CDDataset(data_root, "train"), **kw)
        assert len(ours) == len(theirs)
        for _ in range(2):                   # epochs 0 and 1
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == len(ours)
            for g, w in zip(got, want):
                _equal(g, w)
    if shards == 1 and not drop_last:        # 7 samples: the last batch is padded
        assert want[-1]["valid"].tolist() == [1.0, 0.0, 0.0]


def test_prefetch_to_device_keeps_the_batches(data_root):
    loader = dataset.DataLoader(dataset.CDDataset(data_root, "val"), 2, shuffle=False,
                                num_workers=2)
    want = list(loader)
    got = list(dataset.prefetch_to_device(iter(loader), "cpu"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), w[k])
