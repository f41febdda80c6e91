"""Fault-tolerant checkpointing: async, atomic (mirrors
``src/repro/checkpoint/store.py``, with the same on-disk format).

* **atomic commit** — state is written to ``step_N.tmp/``, a content
  manifest (per-leaf shape/dtype/crc) is written last, then the directory
  is renamed to ``step_N/``.  A crash mid-write never corrupts the latest
  good checkpoint; ``latest_step`` only believes directories with a
  complete manifest.
* **async** — ``save_async`` copies every leaf to the host and hands
  serialization to a background thread; ``wait()`` joins before the next
  save (a single outstanding snapshot).
* **one format for both packages** — leaves are stored whole, one
  ``leaf_%05d.npy`` each, in the reference's flatten order
  (:func:`tree_flatten`: dict keys sorted, tuples and NamedTuples in
  order), so each package reads what the other wrote.  A bfloat16 leaf,
  which numpy lacks, is written as the reference's ``ml_dtypes`` writes
  it: descr ``<V2`` over the raw 2-byte words, ``bfloat16`` in the
  manifest; it is read back through those words.  The crc is taken over
  the raw bytes.
* **exact data resume** — the pipeline cursor rides in ``extra``.

* **mesh-shape independence** — a DTensor leaf is saved whole: its
  shards are gathered on every rank (a collective) and rank 0 alone
  writes, then the ranks meet at a barrier.  ``restore`` gives each leaf
  on the device of the matching leaf of ``like``, or, where
  ``placements`` gives one for it, as a DTensor of those placements on
  ``mesh``, cut from the whole leaf every rank reads: a checkpoint
  written on one mesh restores on another, or on one process.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

BF16_DESCR = "<V2"         # how numpy writes an ml_dtypes bfloat16 array


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_flatten(tree: Any) -> Tuple[List[Any], str]:
    """(leaves, structure) in the reference's ``jax.tree_util`` order:
    dict values by sorted key, tuple, list and NamedTuple items in order;
    anything else is a leaf.  The structure is written as JAX prints its
    ``PyTreeDef``."""
    leaves: List[Any] = []

    def walk(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}" for k in sorted(node)) + "}"
        if _is_namedtuple(node):
            return (f"CustomNode(namedtuple[{type(node).__name__}], ["
                    + ", ".join(walk(c) for c in node) + "])")
        if isinstance(node, tuple):
            inner = ", ".join(walk(c) for c in node)
            return "(" + inner + ("," if len(node) == 1 else "") + ")"
        if isinstance(node, list):
            return "[" + ", ".join(walk(c) for c in node) + "]"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*[build(c) for c in node])
        if isinstance(node, (tuple, list)):
            return type(node)(build(c) for c in node)
        return next(it)

    return build(like)


def _leaves_like(tree: Any, like: Any) -> List[Any]:
    """``tree``'s nodes at the places of ``like``'s leaves, in flatten
    order: ``tree`` has ``like``'s structure down to those places, and
    whatever it holds there (a list of placements, None) is one leaf."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _leaves_like(tree[k], like[k])]
    if isinstance(like, (tuple, list)):
        return [x for t, l in zip(tree, like) for x in _leaves_like(t, l)]
    return [tree]


def _host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A copy of ``leaf`` on the host as numpy, and its manifest dtype; a
    bfloat16 leaf as its raw 2-byte words.  A DTensor is gathered whole."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.int16), "bfloat16"
    return arr, str(arr.dtype)


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}.npy"


class CheckpointStore:
    def __init__(self, root: str):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._meet = False               # the last save was a distributed one

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        best = None
        for d in self.root.glob("step_*"):
            if not d.is_dir() or not (d / "MANIFEST.json").exists():
                continue
            try:
                manifest = json.loads((d / "MANIFEST.json").read_text())
                if manifest.get("complete"):
                    step = int(d.name.split("_")[1])
                    best = step if best is None else max(best, step)
            except (ValueError, json.JSONDecodeError):
                continue
        return best

    # ------------------------------------------------------------------
    def _write(self, step: int, host_leaves: List[Tuple[np.ndarray, str]],
               treedef_repr: str, extra: Dict[str, Any]) -> None:
        tmp = self.root / f"step_{step}.tmp"
        final = self.root / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "treedef": treedef_repr,
                    "extra": extra, "leaves": [], "complete": True}
        for i, (arr, dtype) in enumerate(host_leaves):
            with open(tmp / _leaf_name(i), "wb") as f:
                if dtype == "bfloat16":
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": BF16_DESCR, "fortran_order": False,
                            "shape": arr.shape})
                    f.write(arr.tobytes())
                else:
                    np.save(f, arr)
                f.flush()
            manifest["leaves"].append({
                "name": _leaf_name(i),
                "shape": list(arr.shape),
                "dtype": dtype,
                "crc": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
            })
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)

    # ------------------------------------------------------------------
    def _snapshot(self, state: Any):
        """(host leaves, structure, whether this rank writes): DTensor leaves
        are gathered on every rank, and rank 0 alone writes them."""
        self.wait()
        leaves, treedef = tree_flatten(state)
        host = [_host(l) for l in leaves]
        self._meet = any(isinstance(l, DTensor) for l in leaves)
        return host, treedef, not self._meet or dist.get_rank() == 0

    def save(self, step: int, state: Any,
             extra: Optional[Dict[str, Any]] = None) -> None:
        host, treedef, writes = self._snapshot(state)
        if writes:
            self._write(step, host, treedef, extra or {})
        self.wait()

    def save_async(self, step: int, state: Any,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        host, treedef, writes = self._snapshot(state)                # snapshot
        if writes:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, treedef, extra or {}),
                daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the outstanding write; after a distributed save, the ranks
        meet here, so none reads before rank 0 has written."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._meet:
            self._meet = False
            dist.barrier()

    # ------------------------------------------------------------------
    def restore(self, step: int, like: Any, placements: Optional[Any] = None,
                mesh=None) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure of ``like``: each leaf a tensor of the
        manifest's dtype, on the device of ``like``'s leaf where that is a
        tensor, else on the CPU.  ``placements``, a tree of ``like``'s
        structure with a list of DTensor placements (or None) for each
        leaf, makes those leaves DTensors on ``mesh``."""
        d = self.root / f"step_{step}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        leaves_like, _ = tree_flatten(like)
        if len(manifest["leaves"]) != len(leaves_like):
            raise ValueError(f"checkpoint/state structure mismatch: "
                             f"{len(manifest['leaves'])} leaves stored, "
                             f"{len(leaves_like)} expected")
        layout = ([None] * len(leaves_like) if placements is None
                  else _leaves_like(placements, like))
        if any(pl is not None for pl in layout) and mesh is None:
            raise ValueError("restoring onto placements needs their mesh")
        out = []
        for meta, ref, pl in zip(manifest["leaves"], leaves_like, layout):
            arr = np.load(d / meta["name"])
            if zlib.crc32(arr.tobytes()) & 0xFFFFFFFF != meta["crc"]:
                raise IOError(f"checksum mismatch in {meta['name']}")
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            t = t.to(ref.device) if isinstance(ref, torch.Tensor) else t
            out.append(t if pl is None else
                       distribute_tensor(t, mesh, pl, src_data_rank=None))
        return tree_unflatten(like, out), manifest["extra"]

    def restore_latest(self, like: Any, placements: Optional[Any] = None, mesh=None):
        step = self.latest_step()
        if step is None:
            return None
        state, extra = self.restore(step, like, placements, mesh)
        return step, state, extra

    # ------------------------------------------------------------------
    def gc(self, keep: int = 3) -> None:
        steps = sorted(
            int(d.name.split("_")[1]) for d in self.root.glob("step_*")
            if d.is_dir() and (d / "MANIFEST.json").exists())
        for s in steps[:-keep]:
            shutil.rmtree(self.root / f"step_{s}", ignore_errors=True)
