"""Integrity-checked checkpoints on disk (port of
``repro.checkpoint.store``: ``save_checkpoint``, ``load_checkpoint``,
``latest_step``, the asynchronous ``AsyncCheckpointer`` and
``restore_with_shardings``, which slices a loaded full tree into this
rank's shards for a mesh).  Checkpoints hold full trees: a sharded run
gathers to rank 0 and saves there, so any mesh restores them.

Layout, the reference's byte for byte:  <root>/step_<N>/
            manifest.json     {step, meta, leaves: {key: shape, dtype, crc32}}
            <flatkey>.npy     one raw array per leaf

* atomic: written to ``step_<N>.tmp0`` then renamed;
* integrity: crc32 per leaf over the raw bytes, verified on load;
* keys: the path of each leaf joined by ``__`` -- dict keys in sorted
  order, list and tuple indices -- as ``jax.tree_util`` flattens the
  same tree, so each package loads the other's checkpoints.

Leaves are torch tensors or numpy arrays.  numpy has no bfloat16: a
bf16 tensor is written as its ``uint16`` bit pattern under
``"dtype": "bfloat16"`` (what the reference writes for an
``ml_dtypes.bfloat16`` array) and read back as a bf16 tensor through
an ``int16`` view; nothing here imports ``ml_dtypes``.  Loaded leaves
are CPU torch tensors.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import zlib

import numpy as np
import torch

# the reference's restore_with_shardings: this rank's shards of a loaded
# full tree under a mesh's specs (possibly another mesh than the one
# that saved it)
from repro_torch.distributed.sharding import \
    shard_tree as restore_with_shardings

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "AsyncCheckpointer", "CheckpointCorruptionError",
           "restore_with_shardings"]

_SEP = "__"


class CheckpointCorruptionError(OSError):
    """A checkpoint on disk fails its integrity checks: per-leaf crc32
    mismatch, unreadable/truncated ``.npy``, shape drift against the
    manifest, an unreadable manifest, or missing leaves.  Subclasses
    ``OSError`` so ``except OSError`` recovery paths treat it as a bad
    checkpoint -- never deserialized into state."""


def _flatten(tree, prefix: tuple = ()):
    """(key, leaf) pairs in ``jax.tree_util``'s order: dict keys sorted,
    sequences by index, ``None`` an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    elif tree is not None:
        yield _SEP.join(prefix), tree


def _unflatten(like, leaves: dict, prefix: tuple = ()):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return leaves[_SEP.join(prefix)]


def _raw(leaf) -> tuple[np.ndarray, str]:
    """The array written to disk and the logical dtype named in the
    manifest."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub":   # e.g. an ml_dtypes bfloat16 array
        return arr.view(np.uint16 if arr.dtype.itemsize == 2
                        else np.uint8), str(arr.dtype)
    return arr, str(arr.dtype)


def save_checkpoint(root: str, step: int, tree, *, keep: int = 3,
                    meta: dict | None = None) -> str:
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp0"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "meta": meta or {}, "leaves": {}}
    for key, leaf in _flatten(tree):
        raw, dtype = _raw(leaf)
        np.save(os.path.join(tmp, key + ".npy"), raw)
        manifest["leaves"][key] = {
            "shape": list(raw.shape),
            "dtype": dtype,
            "crc32": zlib.crc32(np.ascontiguousarray(raw).tobytes()),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(root, keep)
    return final


def _gc(root: str, keep: int):
    steps = sorted(
        d for d in os.listdir(root)
        if d.startswith("step_") and not d.endswith(".tmp0"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)


def latest_step(root: str) -> int | None:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(root)
             if d.startswith("step_") and "." not in d]
    return max(steps) if steps else None


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if str(arr.dtype) == dtype:
        return torch.from_numpy(arr)
    if dtype == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    raise ValueError(f"cannot restore a {arr.dtype} leaf as {dtype}")


def load_checkpoint(root: str, step: int, like_tree) -> tuple:
    """Returns (tree shaped like ``like_tree`` of CPU tensors, manifest
    meta).

    Every leaf is integrity-checked against the manifest (crc32 over the
    raw bytes, written at save time) before anything is handed back:
    truncated or bit-flipped files raise
    :class:`CheckpointCorruptionError` instead of deserializing garbage
    into state."""
    path = os.path.join(root, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise  # no checkpoint at all: not corruption
    except (OSError, ValueError) as e:
        raise CheckpointCorruptionError(
            f"unreadable manifest @ step {step}: {e}") from e
    leaves = {}
    for key, info in manifest["leaves"].items():
        try:
            arr = np.load(os.path.join(path, key + ".npy"))
        except FileNotFoundError as e:
            raise CheckpointCorruptionError(
                f"checkpoint leaf {key} missing @ step {step}") from e
        except (OSError, ValueError, EOFError) as e:
            raise CheckpointCorruptionError(
                f"checkpoint leaf {key} unreadable (truncated?) "
                f"@ step {step}: {e}") from e
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
        if crc != info["crc32"]:
            raise CheckpointCorruptionError(
                f"checkpoint corruption in {key} @ step {step} "
                f"(crc32 {crc} != manifest {info['crc32']})")
        if list(arr.shape) != list(info["shape"]):
            raise CheckpointCorruptionError(
                f"checkpoint leaf {key} shape {list(arr.shape)} != "
                f"manifest {info['shape']} @ step {step}")
        leaves[key] = _to_tensor(arr, info["dtype"])
    missing = {k for k, _ in _flatten(like_tree)} - set(leaves)
    if missing:
        raise CheckpointCorruptionError(
            f"checkpoint missing leaves: {sorted(missing)[:5]}")
    return _unflatten(like_tree, leaves), manifest["meta"]


def _host_copy(tree):
    """A host copy of every leaf, taken now: tensors to new CPU tensors
    (one device-to-host copy per leaf, a copy on the CPU too), numpy
    arrays copied."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if tree is None:
        return None
    return np.array(tree, copy=True)


class AsyncCheckpointer:
    """Copy to the host, then write from a worker thread.

    :meth:`save` copies the tree to the host before it returns, so the
    training step that follows may update the parameters and the
    optimizer state in place (``repro_torch.optim.adamw_update`` does)
    while the worker writes the copy.  A write error is raised by the
    next :meth:`save`, :meth:`wait` or :meth:`close`."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: Exception | None = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, host_tree, meta = item
            try:
                save_checkpoint(self.root, step, host_tree, keep=self.keep,
                                meta=meta)
            except Exception as e:  # noqa: BLE001 -- raised on the caller
                self._err = e
            finally:
                self._q.task_done()

    def save(self, step: int, tree, meta: dict | None = None, *,
             copy: bool = True):
        """Queue ``tree`` for writing; ``copy=False`` takes a tree that
        already is a host copy no one else writes (``sharding.
        gather_to_root``'s) as it is."""
        if self._err:
            raise self._err
        self._q.put((step, _host_copy(tree) if copy else tree, meta))

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self._q.put(None)
        self._t.join(timeout=30)
        if self._err:
            raise self._err
