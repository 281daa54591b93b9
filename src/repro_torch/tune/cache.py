"""On-disk autotune winner cache (port of ``repro.tune.cache``).

The reference's JSON format, keys and atomic write, so each package
reads a cache file the other wrote: a file keyed by ``(shape bucket,
dtype, backend)`` (``"cuda"`` on the card, ``"cpu"`` here), buckets
per-dimension next-powers-of-two.  The ``"cuda"`` keyspace alone also
buckets M <= 8 apart (:func:`cache_key`).  Writes go to a temporary file
and ``os.replace`` (atomic on POSIX); a missing or corrupt file reads as
an empty cache.  ``REPRO_TUNE_CACHE`` names the file; without it the
port keeps its own file, apart from the reference's, so winners scored
under another part's constants are never served here by default.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile

from repro_torch.core.schedule import _ceil_pow2
from repro_torch.kernels.sfc_matmul import ROWS_MAX_M
from repro_torch.obs.metrics import default_registry

__all__ = ["TuneCache", "default_cache_path", "shape_bucket", "cache_key"]

_ENV_PATH = "REPRO_TUNE_CACHE"
_VERSION = 1



def default_cache_path() -> str:
    if os.environ.get(_ENV_PATH):
        return os.environ[_ENV_PATH]
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro_torch", "tune.json")


def shape_bucket(m: int, n: int, k: int) -> tuple[int, int, int]:
    """Per-dimension next-power-of-two bucket (min 128)."""
    return tuple(max(128, _ceil_pow2(int(d))) for d in (m, n, k))


def cache_key(m: int, n: int, k: int, dtype: str, backend: str,
              batched: bool = False, objective: str = "time",
              epilogue: str | None = None,
              attn: str | None = None,
              comm: str | None = None) -> str:
    """Winner-cache key.  Non-default objectives get their own keyspace
    (``.../obj=edp``): a winner adjudicated on wall time must never be
    served to an energy- or EDP-optimising caller; ``"time"`` keeps the
    historical unsuffixed form so existing caches stay valid.

    ``epilogue`` (an :class:`repro_torch.tune.cost.EpilogueSpec` tag such as
    ``bias+gelu+res``) likewise gets its own keyspace: a fused epilogue
    removes whole HBM passes from the candidate traffic, so the winner
    for ``dot`` and the winner for ``dot+epilogue`` are different
    searches (DESIGN.md §9).  Bare GEMMs keep the unsuffixed key.

    ``attn`` (an :class:`repro_torch.tune.cost.AttnSpec` tag such as
    ``paged-p8``) keys the decode-attention winners (DESIGN.md §10):
    the kernel tag replaces the ``mm``/``bmm`` prefix with ``attn`` and
    the shape is (slots, kv_width, cache_len) -- a paged winner and a
    contiguous winner are different searches with different byte curves,
    and neither may leak into the GEMM keyspace.

    ``comm`` (a :class:`repro_torch.tune.cost.CommSpec` tag such as
    ``tp8-h2.50``) is the mesh keyspace (DESIGN.md §15): the tag carries
    the collective's ring size AND the mean hop distance of the mesh's
    curve embedding, so winners scored under one placement's
    bytes-over-links curve are never served to a mesh embedded along a
    different curve.  Single-chip callers (``comm=None``) keep the
    historical unsuffixed key.

    On ``"cuda"`` a GEMM with M <= 8 gets its own M bucket (``8``): the
    port's kernel runs it on the rows path, a different launch from the
    tile path's at M = 9..128, so a winner measured on one must never be
    served to the other.  Every other key is the reference's."""
    bm_, bn_, bk_ = shape_bucket(m, n, k)
    if backend == "cuda" and not attn and m <= ROWS_MAX_M:
        bm_ = ROWS_MAX_M
    tag = "attn" if attn else ("bmm" if batched else "mm")
    key = f"{tag}/{bm_}x{bn_}x{bk_}/{dtype}/{backend}"
    if objective != "time":
        key += f"/obj={objective}"
    if epilogue and epilogue != "none":
        key += f"/ep={epilogue}"
    if attn:
        key += f"/attn={attn}"
    if comm and comm != "none":
        key += f"/comm={comm}"
    return key


class TuneCache:
    """Dict-like persistent cache of tuning winners.

    Entries are plain JSON dicts (``TuneConfig.to_dict()`` plus metadata);
    interpretation is the caller's job, keeping this module dependency-free.
    """

    def __init__(self, path: str | None = None):
        self.path = path or default_cache_path()
        self._data: dict | None = None

    # ------------------------------------------------------------- load/save
    def _read_disk(self) -> dict:
        try:
            with open(self.path) as f:
                raw = json.load(f)
            if not isinstance(raw, dict) or raw.get("version") != _VERSION:
                raise ValueError("unknown cache layout")
            entries = raw.get("entries")
            if not isinstance(entries, dict):
                raise ValueError("bad entries")
            return entries
        except (OSError, ValueError, json.JSONDecodeError):
            # missing, unreadable or corrupt: start empty (recovered on
            # the next put(), which rewrites the whole file atomically)
            return {}

    def _load(self) -> dict:
        if self._data is None:
            self._data = self._read_disk()
        return self._data

    def _save(self) -> None:
        payload = {"version": _VERSION, "entries": self._data or {}}
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".tune-", suffix=".json", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)  # atomic publish
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise

    # ------------------------------------------------------------------ api
    def get(self, key: str) -> dict | None:
        hit = self._load().get(key)
        # per-keyspace hit/miss telemetry (DESIGN.md §12): the keyspace
        # is the key's kernel-kind prefix (mm / bmm / attn), so one
        # snapshot shows which searches the on-disk cache is absorbing.
        # NB: in-process memo hits (_memoised_resolve) never reach here.
        keyspace = key.split("/", 1)[0]
        default_registry().counter(
            f"tune.cache.{'hit' if hit is not None else 'miss'}"
            f".{keyspace}").inc()
        return hit

    def put(self, key: str, entry: dict) -> None:
        # merge-on-write: re-read the file so entries persisted by other
        # processes since our snapshot survive the rewrite; disk wins on
        # key conflicts (it is fresher -- every mutation saves
        # immediately), while in-memory entries whose save failed
        # (read-only path) still carry forward.  The remaining
        # read->replace race window is inherent without file locking and
        # costs at most a re-search, never a torn file.
        data = dict(self._load())
        data.update(self._read_disk())
        data[key] = entry
        self._data = data
        self._save_best_effort()

    def invalidate(self, key: str | None = None) -> None:
        if key is None:
            self._data = {}
        else:
            data = self._read_disk()
            data.pop(key, None)
            self._data = data
        self._save_best_effort()

    def _save_best_effort(self) -> None:
        # an unwritable cache path (read-only HOME in hermetic CI) must
        # never kill serving: the in-memory result stays valid, only
        # persistence is lost
        with contextlib.suppress(OSError):
            self._save()

    def __len__(self) -> int:
        return len(self._load())

    def __iter__(self):
        return iter(self._load())

    def keys(self):
        return self._load().keys()
