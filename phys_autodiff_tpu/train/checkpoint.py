"""Checkpoint save/restore for training state.

New capability relative to the reference, which keeps weights in in-memory
vectors regenerated from seeds each run (include/mlp_grid.h:19-24, survey
§5 "Checkpoint / resume: absent"). One format, dependency-free: a flat
.npz of leaves + a JSON tree manifest — robust and human-inspectable.
"""

from __future__ import annotations

import json
import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


def _flatten(tree: Any):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return leaves, treedef


def save_npz(
    path: str,
    tree: Any,
    meta: dict | None = None,
    extra: dict | None = None,
) -> None:
    """Save any pytree (TrainState, params dict, ...) to <path>.npz (+ a
    human-readable <path>.tree.json sidecar). The manifest is EMBEDDED in
    the .npz itself, so the checkpoint is a single atomically-replaced
    file — a crash can never pair a new .npz with a stale manifest, and a
    copied-alone .npz keeps its structure validation.

    `meta`: optional JSON-safe dict stored in the manifest and validated by
    restore_npz(expect_meta=...) — e.g. ngp.checkpoint_meta(cfg), so an NGP
    checkpoint records its encoding schedule (level resolutions once changed
    from floor to round; tables with the same SHAPES decode to different
    fields under a different schedule).

    `extra`: optional JSON-safe dict stored in the manifest but NOT part of
    the expect_meta contract — for run-varying bookkeeping (e.g.
    fit_resilient's completed-step counter) that must ride the same atomic
    file without breaking a caller's exact-meta validation. Read it back
    with read_manifest()."""
    leaves, treedef = _flatten(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    npz_path = path if path.endswith(".npz") else path + ".npz"
    manifest_dict = {"treedef": str(treedef), "n_leaves": len(leaves)}
    if meta is not None:
        manifest_dict["meta"] = meta
    if extra is not None:
        manifest_dict["extra"] = extra
    manifest_json = json.dumps(manifest_dict)
    tmp = npz_path + ".tmp.npz"
    np.savez(
        tmp,
        __manifest__=np.frombuffer(manifest_json.encode(), dtype=np.uint8),
        **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)},
    )
    os.replace(tmp, npz_path)
    # non-authoritative human-readable sidecar
    sidecar = npz_path[: -len(".npz")] + ".tree.json"
    tmp_sidecar = sidecar + ".tmp"
    with open(tmp_sidecar, "w") as f:
        f.write(manifest_json)
    os.replace(tmp_sidecar, sidecar)


def read_manifest(path: str) -> dict | None:
    """Return the checkpoint's manifest dict (embedded, or the legacy
    .tree.json sidecar) without restoring any leaves; None when the
    checkpoint carries neither. Keys: treedef, n_leaves, and the optional
    meta / extra dicts passed to save_npz."""
    npz_path = path if path.endswith(".npz") else path + ".npz"
    sidecar = npz_path[: -len(".npz")] + ".tree.json"
    with np.load(npz_path) as data:
        if "__manifest__" in data.files:
            return json.loads(bytes(data["__manifest__"].tobytes()).decode())
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            return json.load(f)
    return None


def restore_npz(
    path: str,
    like: Any,
    expect_meta: dict | None = None,
    allow_unvalidated: bool = False,
) -> Any:
    """Restore into the structure of `like` (a pytree with the same shape).

    The manifest (embedded in the .npz; legacy checkpoints fall back to the
    .tree.json sidecar) is validated against `like` (leaf count and treedef
    string) so a structurally different `like` cannot silently mis-assign
    leaves by index. A checkpoint with no manifest at all is refused unless
    `allow_unvalidated=True`, which falls back to the older leaf-count
    check with a warning (.npz files copied without their sidecar were once
    loadable).

    `expect_meta`: if given and the checkpoint carries a manifest "meta"
    entry, the two must be equal (e.g. an NGP encoding-schedule fingerprint
    — ngp.checkpoint_meta); checkpoints saved without meta restore with a
    warning, since their schedule cannot be verified."""
    npz_path = path if path.endswith(".npz") else path + ".npz"
    leaves_like, treedef = _flatten(like)
    sidecar = npz_path[: -len(".npz")] + ".tree.json"
    with np.load(npz_path) as data:
        if "__manifest__" in data.files:
            meta = json.loads(bytes(data["__manifest__"].tobytes()).decode())
        elif os.path.exists(sidecar):
            with open(sidecar) as f:
                meta = json.load(f)
        elif allow_unvalidated:
            import warnings

            n_data = len([k for k in data.files if k.startswith("leaf_")])
            if n_data != len(leaves_like):
                raise ValueError(
                    f"checkpoint has {n_data} leaves but `like` has "
                    f"{len(leaves_like)} — structure mismatch"
                )
            warnings.warn(
                f"checkpoint {npz_path} has no manifest; restoring by leaf "
                "index only (tree structure unverified)",
                stacklevel=2,
            )
            meta = None
        else:
            raise ValueError(
                f"checkpoint {npz_path} has no embedded manifest and no "
                f"{sidecar} sidecar — cannot validate the tree structure "
                "(pass allow_unvalidated=True to restore by leaf index)"
            )
        if meta is not None:
            if meta.get("n_leaves") != len(leaves_like):
                raise ValueError(
                    f"checkpoint has {meta.get('n_leaves')} leaves but `like` "
                    f"has {len(leaves_like)} — structure mismatch"
                )
            if meta.get("treedef") != str(treedef):
                raise ValueError(
                    "checkpoint treedef does not match `like`:\n"
                    f"  saved: {meta.get('treedef')}\n  like:  {treedef}"
                )
        # expect_meta is checked even for manifest-less restores
        # (allow_unvalidated=True used to skip it silently): an explicitly
        # requested schedule check must fire or say why it cannot.
        if expect_meta is not None:
            saved = meta.get("meta") if meta is not None else None
            if saved is None:
                import warnings

                warnings.warn(
                    f"checkpoint {npz_path} carries no meta entry; "
                    f"expected {expect_meta} cannot be verified",
                    stacklevel=2,
                )
            elif saved != expect_meta:
                raise ValueError(
                    "checkpoint meta does not match:\n"
                    f"  saved:    {saved}\n  expected: {expect_meta}"
                )
        leaves = [jnp.asarray(data[f"leaf_{i}"]) for i in range(len(leaves_like))]
    return jax.tree_util.tree_unflatten(treedef, leaves)
