"""Checkpointing: atomic, keep-last-k, restore onto any device (port of
``repro.checkpoint.manager``, the same files on disk).

  * save(): copy each tensor to the host, write one ``leaves.npz`` and a
    ``manifest.json`` (leaf names and dtypes) per step into a temp dir,
    fsync, then atomically rename it to ``step_{N:08d}`` — a crash mid-save
    never corrupts the latest checkpoint (the rename is the commit point).
  * restore(): loads the newest readable checkpoint into the structure of
    a template and places every leaf on the template leaf's device, on
    ``device``, or on a mesh (``shardings``: a tree of
    ``runtime.sharding.Sharding``, the counterpart of the reference's
    ``shardings``), so a checkpoint saved on one mesh restores onto
    another.
  * Over a mesh every rank calls save(): each DTensor leaf is gathered
    whole, rank 0 writes the files, and the ranks meet at a barrier before
    save returns.
  * keep_last limits disk usage; an optional async thread writes the files
    off the training loop (the copy to the host happens before it starts).

The tree is a nested dict (or tuple/list) of tensors; leaves are flattened
in sorted key order with "/"-joined names, as ``jax.tree_util`` flattens a
dict, so each package reads the other's checkpoints. numpy has no
bfloat16: such a leaf is stored as its uint16 bits with the dtype tag
"bfloat16" (the reference's own convention), and read back by
``torch.from_numpy(bits).view(torch.bfloat16)``.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
import threading
import warnings
import zipfile

import numpy as np
import torch

_MANIFEST = "manifest.json"


def _flatten(tree, prefix=()) -> list[tuple[str, object]]:
    """[(name, leaf)] in ``jax.tree_util``'s order: dict keys sorted,
    sequences in order."""
    if isinstance(tree, dict):
        return [it for k in sorted(tree)
                for it in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (tuple, list)):
        return [it for i, v in enumerate(tree)
                for it in _flatten(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(template, leaves: list):
    """``template``'s structure with its leaves replaced, in
    :func:`_flatten`'s order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(template)


def _structure(tree):
    if isinstance(tree, dict):
        return {str(k): _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return [_structure(v) for v in tree]
    return None


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def _to_host(leaf) -> torch.Tensor:
    """A copy of ``leaf`` on the CPU (never a view of the caller's
    memory, so a later in-place write cannot reach an async save); a
    DTensor gathered whole first."""
    t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
    if _is_dtensor(t):
        t = t.full_tensor()
    return t.detach().to("cpu", copy=True)


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the array stored, its dtype tag)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, tag: str | None) -> torch.Tensor:
    if tag == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if tag is not None and tag != str(a.dtype):
        raise ValueError(f"stored {a.dtype} tagged {tag}: not a dtype "
                         "this package reads")
    return torch.from_numpy(np.array(a))


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep_last: int = 3,
                 async_save: bool = False):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.async_save = async_save
        self._pending: threading.Thread | None = None

    # -- write ----------------------------------------------------------
    def save(self, step: int, tree) -> pathlib.Path:
        flat = _flatten(tree)
        named = [(n, _to_host(leaf)) for n, leaf in flat]
        structure = _structure(tree)
        meshed = [leaf for _, leaf in flat if _is_dtensor(leaf)]
        if meshed:
            import torch.distributed as dist

            if dist.get_rank() == 0:
                self._write(step, named, structure)
            # under NCCL the barrier runs on this rank's own card
            cuda = meshed[0].device_mesh.device_type == "cuda"
            dist.barrier(device_ids=[torch.cuda.current_device()]
                         if cuda else None)
            return self.dir / f"step_{step:08d}"
        if self.async_save:
            self.wait()
            t = threading.Thread(target=self._write,
                                 args=(step, named, structure))
            t.start()
            self._pending = t
            return self.dir / f"step_{step:08d}"
        return self._write(step, named, structure)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, named, structure) -> pathlib.Path:
        final = self.dir / f"step_{step:08d}"
        tmp = pathlib.Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_"))
        try:
            leaves, dtypes = {}, []
            for i, (_, t) in enumerate(named):
                leaves[f"leaf_{i}"], tag = _to_numpy(t)
                dtypes.append(tag)
            np.savez(tmp / "leaves.npz", **leaves)
            manifest = {
                "step": step,
                "names": [n for n, _ in named],
                "dtypes": dtypes,
                "treedef": json.dumps(structure),
            }
            (tmp / _MANIFEST).write_text(json.dumps(manifest))
            # durability before the commit point: a rename can land on disk
            # before the data it names (write reordering across a power
            # cut), producing a complete-looking but torn checkpoint —
            # fsync both payload files and the temp dir first
            for f in ("leaves.npz", _MANIFEST):
                fd = os.open(tmp / f, os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
            self._fsync_dir(tmp)
            if final.exists():  # idempotent re-save of the same step
                shutil.rmtree(final)
            os.replace(tmp, final)  # commit point
            self._fsync_dir(self.dir)  # persist the rename itself
        finally:
            if tmp.exists():
                shutil.rmtree(tmp, ignore_errors=True)
        self._gc()
        return final

    @staticmethod
    def _fsync_dir(path) -> None:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        except OSError:
            pass  # some filesystems refuse directory fsync; best-effort
        finally:
            os.close(fd)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- read -----------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            if p.name.startswith("step_") and (p / _MANIFEST).exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load_leaves(self, step: int) -> list[torch.Tensor]:
        """One checkpoint's leaves as CPU tensors, bfloat16 rebuilt from
        its bits (any torn/truncated file raises — the caller decides
        whether to fall back)."""
        d = self.dir / f"step_{step:08d}"
        data = np.load(d / "leaves.npz")
        manifest = json.loads((d / _MANIFEST).read_text())
        dtypes = manifest.get("dtypes")
        return [_from_numpy(data[f"leaf_{i}"], dtypes[i] if dtypes else None)
                for i in range(len(data.files))]

    # exception families a torn/truncated checkpoint surfaces as: zip
    # directory damage (BadZipFile subclasses Exception, not OSError),
    # short reads, missing entries, mangled JSON (JSONDecodeError
    # subclasses ValueError)
    _TORN_ERRORS = (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile)

    def restore(self, template, step: int | None = None, device=None,
                shardings=None):
        """Restore into the structure of ``template``; returns (tree,
        step).

        With ``step=None`` the newest *readable* checkpoint wins: a torn
        or truncated latest (crash mid-write on a filesystem that
        reordered around the rename) is skipped with a warning and the
        previous step is restored instead — an explicit ``step`` is
        trusted and raises on damage. Each leaf takes its template leaf's
        dtype and lands on ``device``, or on the template leaf's device
        when None; with ``shardings`` (``template``'s structure, a
        ``runtime.sharding.Sharding`` a leaf) it lands as a DTensor on its
        sharding's mesh, on that mesh's device type.
        """
        leaves = None
        if step is not None:
            leaves = self._load_leaves(step)
        else:
            for cand in reversed(self.all_steps()):
                try:
                    leaves = self._load_leaves(cand)
                    step = cand
                    break
                except self._TORN_ERRORS as e:
                    warnings.warn(
                        f"checkpoint step_{cand:08d} is torn "
                        f"({type(e).__name__}: {e}); falling back to the "
                        "previous step", RuntimeWarning, stacklevel=2)
            if leaves is None:
                raise FileNotFoundError(
                    f"no readable checkpoints in {self.dir}")
        flat_t = [leaf for _, leaf in _flatten(template)]
        if len(flat_t) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(leaves)} leaves, template {len(flat_t)}")
        placed = []
        for leaf, t in zip(leaves, flat_t):
            t = t if isinstance(t, torch.Tensor) else torch.as_tensor(t)
            dev = t.device if device is None else device
            if _is_dtensor(t):
                dev = t.device_mesh.device_type
            placed.append(leaf.to(device=dev, dtype=t.dtype))
        tree = _unflatten(template, placed)
        if shardings is not None:
            from ..runtime import sharding as shd

            tree = shd.distribute(
                shd.tree_zip_map(lambda t, s: t.to(s.mesh.device_type), tree,
                             shardings), shardings)
        return tree, step
