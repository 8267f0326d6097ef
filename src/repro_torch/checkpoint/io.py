"""Checkpoints of the port (`repro/checkpoint/io.py`), in the reference's
on-disk layout, so that either package loads what the other wrote:

  * `arrays.npz`: one array per leaf under its flat key (dict keys joined by
    "/", list items as "#i", tuple items as "!i", so a carry comes back with
    its exact containers), plus the `__save_id__` token; bf16 leaves are
    widened exactly to f32 (npz has no bf16) and narrowed back on load;
  * `manifest.json`: {"step", "dtypes" (each leaf's dtype as JAX names it:
    "float32", "bfloat16", "int32", ...), "extra", "save_id"}.

Two layers:

  * `save_checkpoint` / `load_checkpoint`: a bare tree of tensors (the
    launchers' final params);
  * `save_train_state` / `load_train_state`: the versioned training
    snapshot (`TrainState`): the strategy's carry (params, optimizer state,
    in-flight buffer and, under overlap, the pending snapshot, every
    replica's row), the controller's schedule state, the loss trace so far.
    A run resumed from it gives the uninterrupted run's numbers bit for bit.

Writes are crash-safe: each file lands through a tmp file, fsync and an
atomic rename, and the arrays / manifest pair shares a save token, so a
crash between the two renames leaves a checkpoint that is detected as torn
(`CheckpointCorruptError`). `load_train_state(..., fallback=True)` and
`load_latest_train_state` then take the newest intact `step_XXXXXXXX/`
sibling.

Memory. A save copies one leaf at a time to the host, a row at a time when
the leaf is a strided view on the card, so it allocates nothing on the
card; the npz is written as it goes (`np.savez`'s own format). A
TrainState's manifest also records the carry's aliasing as it was
(`extra["carry_layout"]`: which leaves were one tensor, which were a row
broadcast along the replica axis), and the loader restores exactly that, so
a loaded carry holds no more on the card than the running carry did. A
checkpoint without the record (the JAX package's) loads as dense leaves.

Where the reference takes `shardings` / `carry_shardings`, the loaders here
take `device=` and put every leaf there (sharded placement is ROADMAP item
16). A TrainState's `rng` (the JAX package's uint32 PRNG key) stays a numpy
array: the port draws from `torch.Generator`s and has no use for it.
"""
from __future__ import annotations

import json
import os
import re
import zipfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.flatbuf import dtype_name
from repro_torch.device import resolve_device

# bump when TrainState's layout changes incompatibly; loaders refuse
# newer-than-known versions instead of misreading them (the reference's
# numbering: v2 records the overlap mode, v3 the effective per-level periods
# in the controller dict)
TRAIN_STATE_VERSION = 3


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        # distinct markers, so tuples come back tuples and lists lists
        mark = "#" if isinstance(tree, list) else "!"
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{mark}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k[:1] == "#" for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        if node and all(k[:1] == "!" for k in node):
            return tuple(fix(node[f"!{i}"]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


class CheckpointCorruptError(ValueError):
    """A checkpoint directory is unreadable: missing or truncated files, an
    unparseable manifest, or an arrays / manifest pair from two different
    saves (a crash landed between the two atomic renames)."""


def _atomic_write(path: str, write_fn) -> None:
    """Crash-safe single-file write: tmp sibling, fsync, atomic rename, then
    fsync of the directory so the rename itself survives a host crash."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _leaf_dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return dtype_name(x.dtype)
    return str(np.asarray(x).dtype)


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A CPU copy of `x` that allocates nothing on its device: a contiguous
    tensor in one copy, a stride-0 (expanded) axis as one row broadcast
    back on the host, any other view row by row (a copy of a strided card
    tensor to the host would first make it contiguous on the card)."""
    if x.device.type == "cpu" or x.is_contiguous():
        return x.cpu()
    if x.stride(0) == 0:
        return _to_host(x[0]).unsqueeze(0).expand(x.shape)
    out = torch.empty(x.shape, dtype=x.dtype)
    for r in range(x.shape[0]):
        out[r] = _to_host(x[r])
    return out


def _host_array(x) -> np.ndarray:
    """The array a leaf is stored as: bf16 widened exactly to f32."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    h = _to_host(x.detach())
    if h.dtype == torch.bfloat16:
        h = h.float()
    return h.numpy()


def _write_npz(f, arrays: Dict[str, Any]) -> None:
    """`np.savez`'s layout (stored zip64 members `<key>.npy`), one leaf on the
    host at a time."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array(fid, _host_array(val), allow_pickle=False)


def save_checkpoint(path: str, tree, *, step: int = 0,
                    extra: Optional[dict] = None) -> None:
    """Write `tree` (tensors on any device, or numpy arrays) as
    `path/arrays.npz` + `path/manifest.json`."""
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    # the two files are renamed in independently; the token stored in both
    # is what lets the loader detect a torn pair
    save_id = f"{step}-{os.getpid()}-{os.urandom(4).hex()}"
    arrays = {"__save_id__": np.frombuffer(save_id.encode(), np.uint8), **flat}
    manifest = {"step": step, "dtypes": {k: _leaf_dtype(v) for k, v in flat.items()},
                "extra": extra or {}, "save_id": save_id}
    _atomic_write(os.path.join(path, "arrays.npz"), lambda f: _write_npz(f, arrays))
    _atomic_write(os.path.join(path, "manifest.json"),
                  lambda f: f.write(json.dumps(manifest, indent=1).encode()))


def _read(path: str) -> Tuple[Dict[str, Tuple[np.ndarray, str]], dict]:
    """({flat key: (host array, dtype name)} in the npz's order, manifest),
    raising `CheckpointCorruptError` on a missing, truncated or torn pair
    (the reference's checks and messages)."""
    man_path = os.path.join(path, "manifest.json")
    npz_path = os.path.join(path, "arrays.npz")
    try:
        with open(man_path) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise CheckpointCorruptError(f"{path}: no manifest.json "
                                     "(incomplete checkpoint)")
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(f"{path}: manifest.json is truncated "
                                     f"or corrupt ({e})")
    try:
        data = np.load(npz_path)
        files = list(data.files)
    except FileNotFoundError:
        raise CheckpointCorruptError(f"{path}: no arrays.npz "
                                     "(incomplete checkpoint)")
    except Exception as e:  # zipfile.BadZipFile, truncated streams, ...
        raise CheckpointCorruptError(f"{path}: arrays.npz is unreadable ({e})")
    with data:
        man_id = manifest.get("save_id")
        if man_id is not None:
            if "__save_id__" not in files:
                raise CheckpointCorruptError(
                    f"{path}: manifest carries save_id {man_id!r} but "
                    "arrays.npz has no token — torn write (arrays from an "
                    "older save)")
            npz_id = bytes(data["__save_id__"]).decode()
            if npz_id != man_id:
                raise CheckpointCorruptError(
                    f"{path}: arrays save_id {npz_id!r} != manifest save_id "
                    f"{man_id!r} — a crash landed between the two renames")
        flat = {}
        try:
            for k in files:
                if k != "__save_id__":
                    flat[k] = (data[k], manifest["dtypes"][k])
        except KeyError as e:
            raise CheckpointCorruptError(f"{path}: arrays/manifest key "
                                         f"mismatch ({e})")
        except Exception as e:  # truncated member streams surface on read
            raise CheckpointCorruptError(f"{path}: arrays.npz member "
                                         f"unreadable ({e})")
    if set(manifest["dtypes"]) - set(flat):
        missing = sorted(set(manifest["dtypes"]) - set(flat))
        raise CheckpointCorruptError(f"{path}: arrays.npz is missing "
                                     f"manifest keys {missing[:4]}...")
    return flat, manifest


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint dtype {name!r} has no torch counterpart")
    return dt


def _tensor(arr: np.ndarray, name: str, device: torch.device) -> torch.Tensor:
    """A stored array as a tensor of its manifest dtype on `device`, narrowed
    to bf16 on the host."""
    t = torch.from_numpy(np.asarray(arr, order="C")).to(_torch_dtype(name))
    return t.to(device)


def _carry_layout(carry) -> Dict[str, Any]:
    """The aliasing of the running carry, by flat key: `shared` maps a leaf
    to the first leaf that is the same tensor (the pending snapshot is the
    params after an overlap merge), `expanded` lists the leaves that are a
    row broadcast along the replica axis (stride 0, as
    `core/daso.py::replica_mean` returns the in-flight mean)."""
    shared, expanded, first = {}, [], {}
    for key, x in _flatten({"carry": carry}).items():
        if not isinstance(x, torch.Tensor):
            continue
        ident = (x.device, x.untyped_storage().data_ptr(), x.storage_offset(),
                 x.dtype, tuple(x.shape), x.stride())
        if ident in first:
            shared[key] = first[ident]
            continue
        first[ident] = key
        if x.dim() and x.shape[0] > 1 and x.stride(0) == 0:
            expanded.append(key)
    return {"shared": shared, "expanded": expanded}


def _carry_tensors(items, layout: Dict[str, Any],
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """[(key, array, dtype name)] -> {key: tensor on `device`}, with the
    aliasing that `layout` (`_carry_layout` at save time) records."""
    shared, expanded = layout.get("shared", {}), set(layout.get("expanded", []))
    out = {}
    for key, arr, name in items:
        if key in shared:
            out[key] = out[shared[key]]
        elif key in expanded:
            out[key] = _tensor(arr[:1], name, device).expand(arr.shape)
        else:
            out[key] = _tensor(arr, name, device)
    return out


_MISSING = object()


def fit_tree(like, tree, path: str = "", *, what: str = "the run"):
    """`tree` (as a checkpoint loads it) held to the structure and shapes of
    `like` leaf by leaf; raises ValueError naming the first path (in the
    checkpoint's key spelling) that differs. Returns `tree` with the empty
    containers of `like` put back, which the npz layout cannot hold (an
    LM's "rem": [] when the block pattern divides the depth)."""
    where = path[:-1] or "the root"
    if isinstance(like, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"{where}: {what} expects a dict here")
        extra = sorted(set(tree) - set(like))
        if extra:
            raise ValueError(f"{path}{extra[0]}: not in {what}")
        return {k: fit_tree(v, tree.get(k, _MISSING), f"{path}{k}/", what=what)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if tree is _MISSING and not like:
            return type(like)()
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError(f"{where}: {what} expects {len(like)} items here")
        mark = "#" if isinstance(like, list) else "!"
        return type(like)(fit_tree(e, g, f"{path}{mark}{i}/", what=what)
                          for i, (e, g) in enumerate(zip(like, tree)))
    if tree is _MISSING:
        raise ValueError(f"{where}: missing from the checkpoint")
    if not isinstance(tree, torch.Tensor) or tuple(tree.shape) != tuple(like.shape):
        shape = tuple(tree.shape) if isinstance(tree, torch.Tensor) else type(tree).__name__
        raise ValueError(f"{where}: checkpoint shape {shape}, {what} "
                         f"expects {tuple(like.shape)}")
    return tree


def load_checkpoint(path: str, *, device="cuda"):
    """(tree of tensors on `device`, manifest). CUDA unless the caller passes
    device="cpu". Raises `CheckpointCorruptError` on a missing, truncated
    or torn checkpoint."""
    device = resolve_device(device)
    flat, manifest = _read(path)
    tree = _unflatten({k: _tensor(a, n, device) for k, (a, n) in flat.items()})
    return tree, manifest


# -- full-state training snapshots -------------------------------------------------

@dataclass
class TrainState:
    """Everything needed to resume training deterministically
    (`repro/checkpoint/io.py::TrainState`). `carry` is the strategy's carry
    as the executors thread it; `controller` is
    `DasoController.state_dict()` (None for sync); `step` doubles as the
    data cursor (the synthetic sources are seeded per (seed, step));
    `membership` is the active-replica mask of an elastic run (None: every
    replica active); `rng` is kept for the reference's checkpoints (the
    port draws no PRNG key)."""
    step: int
    carry: Any
    controller: Optional[Dict[str, Any]] = None
    membership: Optional[List[float]] = None
    rng: Optional[Any] = None
    strategy: str = "daso"
    losses: List[float] = field(default_factory=list)
    extra: Dict[str, Any] = field(default_factory=dict)
    # DasoConfig.overlap when the snapshot was taken: "off" -> 3-slot carry,
    # "one_cycle" -> 4-slot (... + pending snapshot)
    overlap: str = "off"
    version: int = TRAIN_STATE_VERSION


def save_train_state(path: str, state: TrainState) -> None:
    """Write a TrainState: the carry (and rng) into the npz, the host
    scheduling state into the manifest."""
    arrays = {"carry": state.carry}
    if state.rng is not None:
        arrays["rng"] = state.rng
    host = {"version": state.version, "step": state.step,
            "controller": state.controller,
            "membership": state.membership,
            "strategy": state.strategy,
            "overlap": state.overlap,
            "losses": [float(x) for x in state.losses],
            "extra": state.extra}
    save_checkpoint(path, arrays, step=state.step,
                    extra={"train_state": host,
                           "carry_layout": _carry_layout(state.carry)})


_STEP_DIR = re.compile(r"^step_(\d{8})$")


def list_train_state_dirs(ckpt_dir: str) -> List[str]:
    """`step_XXXXXXXX/` snapshot directories under `ckpt_dir`, newest first."""
    try:
        names = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return []
    steps = sorted((m.group(1) for m in map(_STEP_DIR.match, names) if m),
                   reverse=True)
    return [os.path.join(ckpt_dir, f"step_{s}") for s in steps]


def load_train_state(path: str, *, device="cuda",
                     expect_overlap: Optional[str] = None,
                     fallback: bool = False) -> TrainState:
    """Read a TrainState back, its carry on `device` (CUDA unless the caller
    passes device="cpu"). Raises on a checkpoint written by a newer
    TrainState version, or on a bare parameter checkpoint.

    `expect_overlap`: the overlap mode of the resuming run; a carry whose
    layout differs (3 slots against 4) is refused. `fallback`: when `path`
    is truncated or torn, take the newest intact `step_XXXXXXXX/` sibling
    instead (reported with a print)."""
    if fallback:
        try:
            return load_train_state(path, device=device, expect_overlap=expect_overlap)
        except CheckpointCorruptError as e:
            for cand in list_train_state_dirs(os.path.dirname(os.path.abspath(path))):
                if os.path.abspath(cand) == os.path.abspath(path):
                    continue
                try:
                    st = load_train_state(cand, device=device,
                                          expect_overlap=expect_overlap)
                except CheckpointCorruptError:
                    continue
                print(f"[checkpoint] {path} is corrupt ({e}); falling "
                      f"back to newest intact snapshot {cand} "
                      f"(step {st.step})")
                return st
            raise
    device = resolve_device(device)
    flat, manifest = _read(path)
    host = manifest.get("extra", {}).get("train_state")
    if host is None:
        raise ValueError(f"{path} is not a TrainState checkpoint "
                         "(no train_state manifest entry); use "
                         "load_checkpoint for bare parameter snapshots")
    if host["version"] > TRAIN_STATE_VERSION:
        raise ValueError(f"TrainState version {host['version']} is newer "
                         f"than supported {TRAIN_STATE_VERSION}")
    # pre-overlap (v1) checkpoints carry no overlap field: overlap "off"
    ck_overlap = host.get("overlap", "off")
    if expect_overlap is not None and ck_overlap != expect_overlap:
        raise ValueError(
            f"checkpoint {path} was written with overlap={ck_overlap!r} "
            f"(TrainState v{host['version']}) but this run uses "
            f"overlap={expect_overlap!r}; the carry layouts differ "
            f"({'3-slot, no pending arena' if ck_overlap == 'off' else '4-slot with pending arena'}). "
            f"Restart with --overlap {ck_overlap}, or train from scratch.")
    in_carry = [(k, a, n) for k, (a, n) in flat.items()
                if k == "carry" or k.startswith("carry/")]
    layout = manifest["extra"].get("carry_layout", {})
    tree = _unflatten({**{k: a for k, (a, _) in flat.items()},
                       **_carry_tensors(in_carry, layout, device)})
    return TrainState(step=int(host["step"]), carry=tree["carry"],
                      controller=host.get("controller"),
                      membership=host.get("membership"),
                      rng=tree.get("rng"),
                      strategy=host.get("strategy", "daso"),
                      losses=[float(x) for x in host.get("losses", [])],
                      extra=host.get("extra", {}),
                      overlap=ck_overlap,
                      version=int(host["version"]))


def load_latest_train_state(ckpt_dir: str, *, device="cuda",
                            expect_overlap: Optional[str] = None
                            ) -> Tuple[str, TrainState]:
    """The newest intact TrainState under `ckpt_dir`, skipping any snapshot a
    crash left truncated or torn. Returns (path, state)."""
    skipped = []
    for cand in list_train_state_dirs(ckpt_dir):
        try:
            return cand, load_train_state(cand, device=device,
                                          expect_overlap=expect_overlap)
        except CheckpointCorruptError as e:
            skipped.append(f"{os.path.basename(cand)}: {e}")
    raise CheckpointCorruptError(
        f"{ckpt_dir}: no intact TrainState snapshot found"
        + (f" (skipped {'; '.join(skipped)})" if skipped else ""))
