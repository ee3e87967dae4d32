"""The real on-disk formats in the port: `data/make_real_layout.py` against
the JAX package's (mmvae_tpu/data/make_real_layout.py), and the port's
readers (`data/sources.py`) against JAX's on real bytes.

- The IDX and text files the port writes are JAX's byte for byte; the
  .mat and .npz files hold the same keys, dtypes and arrays (their headers
  carry the time of writing); the CelebA PNGs, written by the port's own
  writer, decode to JAX's PIL-written pixels.
- On a layout JAX's `build_layout` wrote, every reader of the port gives
  JAX's arrays, and so does every dataset loader (test splits, unshuffled),
  with MMVAE_TPU_REQUIRE_REAL=1: no loader falls back to the stand-ins.
- The handcrafted cases of tests/test_real_data_formats.py (gzip IDX, the
  label magic, SVHN's 10 -> 0, gray and RGB npz, CelebA's partition and
  +-1 attributes) run as they are, on the port's `sources` and writer.
- CelebA's real layout loads in a process where PIL is blocked, as on the
  card's machine.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import test_real_data_formats as jax_formats
from mmvae_tpu.data import make_real_layout as jlayout
from mmvae_tpu.data import sources as jsources
from mmvae_tpu_torch.data import make_real_layout as layout
from mmvae_tpu_torch.data import sources
from mmvae_tpu_torch.data.png import read_png

N = 128
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT_OR_IDX = [os.path.join(d, "raw", f"{s}-{k}")
               for d in ("MNIST", "FashionMNIST") for s in ("train", "t10k")
               for k in ("images-idx3-ubyte", "labels-idx1-ubyte")] + \
    [os.path.join("celeba", f) for f in ("list_eval_partition.txt", "list_attr_celeba.txt")]
DATASETS = ["mnist_svhn", "mnist_fashion", "medmnist", "chest_svhn", "celeba",
            "mnist_contour", "mnist_svhn_fashion", "binary_mnist_svhn"]


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """(JAX's layout, the port's), both of N train examples a dataset."""
    jdir, pdir = (str(tmp_path_factory.mktemp(n)) for n in ("jax_layout", "port_layout"))
    jlayout.build_layout(jdir, n=N)
    layout.build_layout(pdir, n=N)
    return jdir, pdir


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_same_files(layouts):
    jdir, pdir = layouts
    assert _files(jdir) == _files(pdir)
    assert set(TEXT_OR_IDX) <= set(_files(pdir))


@pytest.mark.parametrize("name", TEXT_OR_IDX)
def test_idx_and_text_files_byte_identical(layouts, name):
    jdir, pdir = layouts
    with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(pdir, name), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("split", ["train", "test"])
def test_svhn_mat_same_contents(layouts, split):
    import scipy.io as sio

    got, want = (sio.loadmat(os.path.join(d, f"{split}_32x32.mat")) for d in layouts)
    keys = sorted(k for k in want if not k.startswith("__"))
    assert keys == sorted(k for k in got if not k.startswith("__")) == ["X", "y"]
    for k in keys:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("flag", ["pneumoniamnist", "bloodmnist"])
def test_medmnist_npz_same_contents(layouts, flag):
    with np.load(os.path.join(layouts[0], f"{flag}.npz")) as want, \
            np.load(os.path.join(layouts[1], f"{flag}.npz")) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_celeba_pngs_same_pixels(layouts):
    from PIL import Image

    sub = os.path.join("celeba", "img_align_celeba", "celeba_64x64", "train")
    names = sorted(os.listdir(os.path.join(layouts[0], sub)))
    assert len(names) == max(64, N // 4)
    for name in names:
        with Image.open(os.path.join(layouts[0], sub, name)) as im:
            want = np.asarray(im)
        assert want.shape == (64, 64, 3)
        np.testing.assert_array_equal(read_png(os.path.join(layouts[1], sub, name)), want)
        np.testing.assert_array_equal(read_png(os.path.join(layouts[0], sub, name)), want)


READERS = {
    "read_idx": lambda m, d: m.read_idx(os.path.join(d, "MNIST", "raw", "t10k-images-idx3-ubyte")),
    "mnist_train": lambda m, d: m.load_mnist(d, True),
    "fashion_test": lambda m, d: m.load_mnist(d, False, fashion=True),
    "svhn_train": lambda m, d: m.load_svhn(d, True),
    "svhn_test": lambda m, d: m.load_svhn(d, False),
    **{f"medmnist_{flag}_{split}": (lambda m, d, f=flag, s=split: m.load_medmnist(d, f, s))
       for flag in ("pneumoniamnist", "bloodmnist") for split in ("train", "val", "test")},
    **{f"celeba_{split}": (lambda m, d, s=split: m.load_celeba(d, s))
       for split in ("train", "val", "test")},
}


@pytest.mark.parametrize("reader", sorted(READERS))
def test_readers_match_jax_on_its_layout(layouts, reader):
    jdir = layouts[0]
    want, got = READERS[reader](jsources, jdir), READERS[reader](sources, jdir)
    want, got = (w if isinstance(w, tuple) else (w,) for w in (want, got))
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", DATASETS)
def test_loaders_off_jax_layout_no_fallback(layouts, name, monkeypatch):
    """Every dataset of the real layout loads with the fallback forbidden,
    and its unshuffled test batches are JAX's."""
    from mmvae_tpu.data import get_dataloaders as jget
    from mmvae_tpu_torch.data import get_dataloaders

    monkeypatch.setenv("MMVAE_TPU_REQUIRE_REAL", "1")
    assert sources.require_real()
    jdir = layouts[0]
    loaders = get_dataloaders(name, data_path=jdir, batch_size=16, shuffle=False)
    want = jget(name, data_path=jdir, batch_size=16, shuffle=False)
    for ours, theirs in zip(loaders, want):
        assert ours.num_examples == len(theirs.dataset) > 0
    (xs, labs), (jxs, jlabs) = next(iter(loaders[1])), next(iter(want[1]))
    for a, b in zip(xs, jxs, strict=True):
        assert np.asarray(a).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(labs, jlabs, strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_require_real_raises_on_missing(tmp_path, monkeypatch):
    monkeypatch.setenv("MMVAE_TPU_REQUIRE_REAL", "1")
    with pytest.raises((FileNotFoundError, OSError)):
        sources.load_or_synthesize(lambda: sources.load_mnist(str(tmp_path), True),
                                   (1, 28, 28), 8, 0)
    monkeypatch.setenv("MMVAE_TPU_REQUIRE_REAL", "0")
    x, y, real = sources.load_or_synthesize(lambda: sources.load_mnist(str(tmp_path), True),
                                            (1, 28, 28), 8, 0)
    assert not real and x.shape == (8, 1, 28, 28)


HANDCRAFTED = ["test_read_idx_handcrafted_bytes", "test_read_idx_gzip_variant",
               "test_read_idx_labels_magic", "test_load_mnist_semantics",
               "test_load_svhn_transpose_and_label_remap", "test_load_medmnist_gray_and_rgb",
               "test_load_celeba_layout"]


@pytest.mark.parametrize("case", HANDCRAFTED)
def test_handcrafted_cases_on_the_port(case, tmp_path, monkeypatch):
    """tests/test_real_data_formats.py's case, its `sources` and
    `make_real_layout` swapped for the port's."""
    monkeypatch.setattr(jax_formats, "sources", sources)
    monkeypatch.setattr(jax_formats, "make_real_layout", layout)
    getattr(jax_formats, case)(tmp_path)


def test_celeba_layout_reads_without_pil(layouts):
    """The port's CelebA layout through the CelebA loader in a process
    where PIL is blocked, with the fallback forbidden."""
    code = "\n".join([
        "import sys",
        "sys.modules['PIL'] = None",
        "from mmvae_tpu_torch.data import get_dataloaders",
        f"l = get_dataloaders('celeba', data_path={layouts[1]!r}, batch_size=8)",
        "print('ok', [x.num_examples for x in l])",
    ])
    env = dict(os.environ, MMVAE_TPU_REQUIRE_REAL="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok [")
