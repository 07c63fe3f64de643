"""Real-data onramp: turn MOUNTED raw datasets into the npy/npz caches the
port's loaders read (``data/loaders.py``, the JAX package's file names).

Counterpart of the JAX package's ``data/real_onramp.py``, with its slices,
seeds and file names, so both packages build the same caches from the same
raw files. It downloads nothing:

- **mnist.npz / fmnist.npz / cifar10.npz** (keras-style archives) are read
  by the loaders directly; nothing to prepare.
- **MNIST-C** (one folder per corruption with ``test_images.npy`` /
  ``test_labels.npy``): for corruption i of the reference's fixed list of
  15, the test slice ``[i*667, min(10000, (i+1)*667))``, concatenated to
  10,000 (reference: case_study_mnist.py:176-209), in slice order.
- **CIFAR-10-C** (``{corruption}.npy`` x 19 + ``labels.npy``): every
  corruption concatenated in sorted file order, labels tiled, the first
  10,000 of ``np.random.default_rng(0).permutation`` (reference:
  case_study_cifar10.py:184-207, which walks ``os.listdir`` order).
- **fmnist-C** (``fmnist-c-test.npy`` + ``fmnist-c-test-labels.npy``):
  scaled to [0, 1] float32 with a channel axis.
- **IMDB raw text** (``imdb/raw/{train,test}.jsonl``, lines of
  ``{"text": ..., "label": 0|1}``): tokenized (vocab 2000, maxlen 100) and
  thesaurus-corrupted at severity 0.5, seed 0, through the port's
  ``data/imdb_prep.build_imdb_caches``, whose word-distance matrix runs on
  ``device`` (the card by default; ``"cpu"`` when asked).

CLI: ``python -m simple_tip_tpu_torch.data.real_onramp [--device cpu]``
scans ``TIP_DATA_DIR`` and builds every cache it finds inputs for.
"""

import json
import logging
import math
import os
from typing import List, Optional, Tuple

import numpy as np

from simple_tip_tpu_torch.config import data_folder
from simple_tip_tpu_torch.device import DeviceLike

logger = logging.getLogger(__name__)

# The reference's fixed corruption list (case_study_mnist.py:31-47).
MNIST_CORRUPTION_TYPES = [
    "shot_noise",
    "impulse_noise",
    "glass_blur",
    "motion_blur",
    "shear",
    "scale",
    "rotate",
    "brightness",
    "translate",
    "stripe",
    "fog",
    "spatter",
    "dotted_line",
    "zigzag",
    "canny_edges",
]

OOD_SIZE = 10_000


def _atomic_save(path: str, array: np.ndarray) -> None:
    tmp = path + ".tmp.npy"
    np.save(tmp, array)
    os.replace(tmp, path)


def prepare_mnist_c(raw_dir: str, out_dir: Optional[str] = None) -> Tuple[str, str]:
    """mnist-c release folders -> ``mnist_c_images.npy``/``mnist_c_labels.npy``.

    Per corruption i: absolute slice [i*ceil(10k/15), min(10k, (i+1)*...))
    of that corruption's test arrays, concatenated and truncated to 10k —
    the reference's tfds ReadInstruction math (case_study_mnist.py:176-209).
    """
    out_dir = out_dir or data_folder()
    img_per_corr = math.ceil(OOD_SIZE / len(MNIST_CORRUPTION_TYPES))
    xs: List[np.ndarray] = []
    ys: List[np.ndarray] = []
    for i, corr in enumerate(MNIST_CORRUPTION_TYPES):
        folder = os.path.join(raw_dir, corr)
        images = np.load(os.path.join(folder, "test_images.npy"))
        labels = np.load(os.path.join(folder, "test_labels.npy"))
        lo, hi = i * img_per_corr, min(OOD_SIZE, (i + 1) * img_per_corr)
        xs.append(images[lo:hi])
        ys.append(labels[lo:hi])
    x = np.concatenate(xs, axis=0)[:OOD_SIZE]
    y = np.concatenate(ys, axis=0)[:OOD_SIZE]
    if len(x) != OOD_SIZE:
        raise ValueError(
            f"mnist-c slices yielded {len(x)} samples, expected {OOD_SIZE} "
            f"(is {raw_dir} the full google-research/mnist-c test release?)"
        )
    if x.ndim == 3:
        x = x[..., None]
    img_path = os.path.join(out_dir, "mnist_c_images.npy")
    lab_path = os.path.join(out_dir, "mnist_c_labels.npy")
    _atomic_save(img_path, x.astype(np.uint8))
    _atomic_save(lab_path, y.astype(np.int64))
    logger.info("mnist-c cache written: %s %s", img_path, x.shape)
    return img_path, lab_path


def prepare_cifar10_c(raw_dir: str, out_dir: Optional[str] = None) -> Tuple[str, str]:
    """Zenodo CIFAR-10-C tar contents -> 10k-sample cache, reference seed.

    Exact reference math (case_study_cifar10.py:184-207): concatenate every
    corruption array, tile labels, take the first 10k indices of
    ``np.random.default_rng(0).permutation``. Deviation, flagged: the
    reference walks ``os.listdir`` (filesystem order); we SORT corruption
    filenames so the draw is reproducible across machines.
    """
    out_dir = out_dir or data_folder()
    files = sorted(f for f in os.listdir(raw_dir) if f.endswith(".npy"))
    if "labels.npy" not in files:
        raise FileNotFoundError(f"labels.npy not found in {raw_dir}")
    labels = np.load(os.path.join(raw_dir, "labels.npy"))
    corruption_files = [f for f in files if f != "labels.npy"]
    if not corruption_files:
        raise FileNotFoundError(f"no corruption npys found in {raw_dir}")
    all_corruptions = np.concatenate(
        [np.load(os.path.join(raw_dir, f)) for f in corruption_files], axis=0
    )
    indexes = np.random.default_rng(0).permutation(len(all_corruptions))[:OOD_SIZE]
    images = all_corruptions[indexes]
    labels = np.tile(labels, len(corruption_files))[indexes]
    img_path = os.path.join(out_dir, "cifar10_c_images.npy")
    lab_path = os.path.join(out_dir, "cifar10_c_labels.npy")
    _atomic_save(img_path, images.astype(np.uint8))
    _atomic_save(lab_path, labels.astype(np.int64))
    logger.info("cifar10-c cache written: %s %s", img_path, images.shape)
    return img_path, lab_path


def prepare_fmnist_c(
    test_images: str, test_labels: str, out_dir: Optional[str] = None
) -> Tuple[str, str]:
    """The reference's shipped fmnist-c files -> our cache names.

    ``fmnist-c-test.npy`` is uint8 (N,28,28); the loader's fmnist path
    expects float32 [0,1] with a channel dim and no further scaling
    (reference divides by 255 and expands dims at
    case_study_fashion_mnist.py:139-143)."""
    out_dir = out_dir or data_folder()
    x = np.load(test_images).astype("float32") / 255.0
    if x.ndim == 3:
        x = x[..., None]
    y = np.load(test_labels).astype(np.int64)
    img_path = os.path.join(out_dir, "fmnist_c_images.npy")
    lab_path = os.path.join(out_dir, "fmnist_c_labels.npy")
    _atomic_save(img_path, x)
    _atomic_save(lab_path, y)
    logger.info("fmnist-c cache written: %s %s", img_path, x.shape)
    return img_path, lab_path


def prepare_imdb_from_jsonl(
    raw_dir: str, out_dir: Optional[str] = None, device: DeviceLike = None
) -> str:
    """``{train,test}.jsonl`` ({"text","label"} lines) -> tokenized caches.

    Reference constants: vocab 2000, maxlen 100, corruption severity 0.5,
    seed 0 (case_study_imdb.py:23-25,319); the thesaurus-corrupted OOD set
    is built through ops.text_corruptor (bundled offline thesaurus, or a
    user wordnet export in TIP_DATA_DIR), its distance matrix on ``device``
    (the card by default)."""
    from simple_tip_tpu_torch.data.imdb_prep import build_imdb_caches

    def _read(split: str):
        texts, labels = [], []
        with open(os.path.join(raw_dir, f"{split}.jsonl")) as f:
            for line in f:
                if line.strip():
                    rec = json.loads(line)
                    texts.append(rec["text"])
                    labels.append(int(rec["label"]))
        if not texts:
            raise ValueError(f"no records in {raw_dir}/{split}.jsonl")
        return texts, labels

    x_train, y_train = _read("train")
    x_test, y_test = _read("test")
    out_folder = os.path.join(out_dir or data_folder(), "imdb")
    build_imdb_caches(
        x_train, y_train, x_test, y_test,
        out_folder=out_folder,
        vocab_size=2000,
        maxlen=100,
        severity=0.5,
        seed=0,
        device=device,
    )
    logger.info("imdb caches written under %s", out_folder)
    return out_folder


def prepare_all(root: Optional[str] = None, device: DeviceLike = None) -> dict:
    """Scan ``root`` (default TIP_DATA_DIR) for raw layouts; build every
    cache whose inputs are present and whose outputs are missing (IMDB's
    corrupted set on ``device``, the card by default). Returns a
    {name: status} report."""
    root = root or data_folder()
    report = {}

    mnist_c_raw = os.path.join(root, "mnist_c")
    if os.path.isdir(mnist_c_raw):
        if os.path.exists(os.path.join(root, "mnist_c_images.npy")):
            report["mnist_c"] = "cache already present"
        else:
            prepare_mnist_c(mnist_c_raw, root)
            report["mnist_c"] = "built"
    else:
        report["mnist_c"] = f"raw not mounted ({mnist_c_raw})"

    cifar_raw = os.path.join(root, "CIFAR-10-C")
    if os.path.isdir(cifar_raw):
        if os.path.exists(os.path.join(root, "cifar10_c_images.npy")):
            report["cifar10_c"] = "cache already present"
        else:
            prepare_cifar10_c(cifar_raw, root)
            report["cifar10_c"] = "built"
    else:
        report["cifar10_c"] = f"raw not mounted ({cifar_raw})"

    fm_img = os.path.join(root, "fmnist-c-test.npy")
    fm_lab = os.path.join(root, "fmnist-c-test-labels.npy")
    if os.path.exists(fm_img) and os.path.exists(fm_lab):
        if os.path.exists(os.path.join(root, "fmnist_c_images.npy")):
            report["fmnist_c"] = "cache already present"
        else:
            prepare_fmnist_c(fm_img, fm_lab, root)
            report["fmnist_c"] = "built"
    else:
        report["fmnist_c"] = f"raw not mounted ({fm_img})"

    imdb_raw = os.path.join(root, "imdb", "raw")
    if os.path.isdir(imdb_raw):
        if os.path.exists(os.path.join(root, "imdb", "x_corrupted.npy")):
            report["imdb"] = "cache already present"
        else:
            prepare_imdb_from_jsonl(imdb_raw, root, device=device)
            report["imdb"] = "built"
    else:
        report["imdb"] = f"raw not mounted ({imdb_raw})"

    for name in ("mnist.npz", "fmnist.npz", "cifar10.npz"):
        report[name] = (
            "present" if os.path.exists(os.path.join(root, name)) else "NOT mounted"
        )
    return report


def main(argv=None) -> int:
    """``python -m simple_tip_tpu_torch.data.real_onramp [--device cpu]``:
    the report table on stdout."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=None, help="default TIP_DATA_DIR")
    parser.add_argument("--device", default=None,
                        help="device of IMDB's corruption: the CUDA card by default, 'cpu' when asked")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    rep = prepare_all(args.root, device=args.device)
    for k, v in sorted(rep.items()):
        print(f"{k:12s} {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
