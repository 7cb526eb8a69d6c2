"""Step-atomic checkpoint manager; the port of ``repro.ckpt.checkpoint``,
with the same on-disk layout, so that a checkpoint written by either
package restores in the other.

Layout: <dir>/step_<N:08d>/ {arrays.npz (the flattened state, ``a0``,
``a1``, ...), index.json (treedef + shapes + dtypes + step + digest)}
written to a tmp dir and renamed -- a crash mid-write never corrupts the
latest checkpoint.  Async mode hands the (host-fetched) state to a
writer thread so the train loop never blocks on disk.  keep_n old steps
are garbage-collected.  ``restore`` loads the newest complete step onto
the device of the structure it restores into, or onto a given device
(the reference's ``restore_resharded`` places onto a mesh; the port has
one card).

Leaves are flattened in the reference's pytree order: a model's
parameters (or a dict of the same names, as the optimizer's moments) in
the JAX layout, paths sorted, each stack of layers one array with the
layer on axis 0 (``models.model.jax_layout``); a NamedTuple's fields in
order (``TrainState``: params, then ``OptState``: step, mu, nu); a
nested dict's keys sorted.  numpy cannot hold bf16 without ml_dtypes, so
a bf16 leaf is written as its uint16 bits under the dtype name
``bfloat16``, as the reference's ``_encode`` writes it, and read back
through an int16 view; nothing here needs ml_dtypes.  ``index.json``'s
``treedef`` lists the leaves' paths (the JAX treedef string names JAX
types); ``restore`` checks the count, shapes and digest, not that
string.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.models.model import jax_layout, jax_path, with_tensors

_BF16 = "bfloat16"


def _named(tree):
    """name -> tensor of a module (its parameters) or of a dict of
    tensors; None for any other node."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    if isinstance(tree, dict) and all(isinstance(v, torch.Tensor)
                                      for v in tree.values()):
        return tree
    return None


def _parts(tree, prefix: str = "") -> list:
    """The leaves of ``tree`` in the reference's pytree order, each as
    (its path, its parts, stacked): a stack of layers is one leaf whose
    parts are its layers (stacked on axis 0), any other leaf is one
    part."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, [tree], False)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, child in zip(tree._fields, tree)
                for x in _parts(child, f"{prefix}{f}/")]
    named = _named(tree)
    if named is not None:
        return [(prefix + "/".join(path), [named[n] for n in names],
                 jax_path(names[0])[1] is not None)
                for path, names in jax_layout(named).items()]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _parts(tree[k],
                                                         f"{prefix}{k}/")]
    raise TypeError(f"cannot flatten a {type(tree).__name__}")


def _unflatten(like, leaves: list):
    """``like``'s structure holding ``leaves`` (consumed from the front),
    each in ``_parts``' order, a stack in one tensor."""
    if isinstance(like, torch.Tensor):
        return leaves.pop(0)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_unflatten(c, leaves) for c in like])
    named = _named(like)
    if named is not None:
        out = {}
        for names in jax_layout(named).values():
            a = leaves.pop(0)
            if jax_path(names[0])[1] is None:
                out[names[0]] = a
            else:
                out.update({n: a[i] for i, n in enumerate(names)})
        return with_tensors(like, out)
    return {k: _unflatten(like[k], leaves) for k in sorted(like)}


def _host(x: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the array as written, its dtype name): bf16 as its uint16 bits."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16), _BF16
    return x.numpy(), str(x.numpy().dtype)


def _tensor(a: np.ndarray, dtype_str: str) -> torch.Tensor:
    """A stored array as a CPU tensor of its stored dtype."""
    if dtype_str == _BF16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes()[:4096])
    return h.hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep_n = keep_n
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------ save

    def save(self, step: int, state: Any, block: bool = False):
        host, names = [], []
        for name, parts, stacked in _parts(state):
            a = [_host(x) for x in parts]
            host.append((np.stack([x for x, _ in a]), a[0][1])
                        if stacked else a[0])
            names.append(name)
        args = (step, [a for a, _ in host], [d for _, d in host],
                ", ".join(names))
        if self.async_write and not block:
            self.wait()
            self._thread = threading.Thread(target=self._write, args=args,
                                            daemon=True)
            self._thread.start()
        else:
            self._write(*args)

    def _write(self, step: int, host, dtypes, treedef_str: str):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": a for i, a in enumerate(host)})
        index = {
            "step": step,
            "n_arrays": len(host),
            "treedef": treedef_str,
            "shapes": [list(a.shape) for a in host],
            "dtypes": dtypes,
            "digest": _digest(host),
        }
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------ load

    def all_steps(self):
        out = []
        for d in sorted(os.listdir(self.dir)):
            if d.startswith("step_") and not d.endswith(".tmp") \
                    and os.path.exists(os.path.join(self.dir, d,
                                                    "index.json")):
                out.append(int(d.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None, device=None):
        """Restore into the structure of `like` (validates the index).
        Each tensor lands on ``device``, or where ``like``'s leaf is, in
        that leaf's dtype.  Returns (state, step) or (None, None) if no
        checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "index.json")) as f:
            index = json.load(f)
        data = np.load(os.path.join(d, "arrays.npz"))
        arrays = [data[f"a{i}"] for i in range(index["n_arrays"])]
        if _digest(arrays) != index["digest"]:
            raise IOError(f"checkpoint step {step} digest mismatch")
        refs = _parts(like)
        if len(refs) != len(arrays):
            raise ValueError(f"checkpoint step {step} holds {len(arrays)} "
                             f"arrays, the structure {len(refs)}")
        out = []
        for (name, parts, stacked), a, dt in zip(refs, arrays,
                                                 index["dtypes"]):
            ref = parts[0]
            want = ((len(parts),) if stacked else ()) + tuple(ref.shape)
            if want != tuple(a.shape):
                raise ValueError(f"checkpoint step {step}: {name} has shape "
                                 f"{tuple(a.shape)}, want {want}")
            out.append(_tensor(a, dt).to(
                device=ref.device if device is None else device,
                dtype=ref.dtype))
        return _unflatten(like, out), step
