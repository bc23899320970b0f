"""Checkpoint / resume (counterpart of ``tetsim_tpu/checkpoint.py``).

``save`` / ``load`` round-trip a SimState (or a dict, list or tuple of
tensors) bit-exactly through one ``.npz`` file, stamped with its structure,
its leaves' shapes and, when given, the mesh's identity (particle and tet
counts, a content hash) and the engine's name; ``load`` checks all of it
and raises a clear error on a mismatch.  The JAX package stamps its pytree
structure instead of the port's structure tag; a file of either package
loads in the other (the leaves, in SimState order, and their shapes are
what both check).

``save_world`` / ``restore_world`` / ``load_world`` (``World.save`` /
``restore`` / ``load``) capture a whole scene in one file: the params,
every body's state and grabs, each body's type, engine and mesh hash, and
the construction specs the ``World.add_*`` calls record, so ``load_world``
rebuilds the scene from the file alone.  The file is the JAX package's
format, shapes and padding included: a fused batch's state is its
[9, B_pad, R] planes (pos, prev, vel; x, y, z), B padded to a multiple of
8 and R to the JAX kernel's lanes, its grabs [B_pad, 1] and [B_pad, 4];
a flat ``BatchedBody`` is one flat SimState with flat grab ids; a
``DenseBody`` its [N, 3, B] columns with grabs [B] and [3, B].  The port
converts at this boundary, so a scene saved by either package resumes in
the other.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from .params import PhysicsParams
from .state import Controls, SimState, check_device

_STATE_FIELDS = ("pos", "prev_pos", "vel", "quats")


def mesh_fingerprint(mesh) -> str:
    """Content hash of a TetMesh's defining arrays (rest verts + tets)."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(mesh.verts, np.float32).tobytes())
    h.update(np.ascontiguousarray(mesh.tets, np.int32).tobytes())
    return h.hexdigest()[:16]


def _flatten(tree):
    """(structure tag, leaves): a SimState's leaves in field order, a dict's
    by sorted key, a list's or tuple's in order; anything else is a leaf."""
    if isinstance(tree, SimState):
        return ("SimState(" + ", ".join(_STATE_FIELDS) + ")",
                [getattr(tree, f) for f in _STATE_FIELDS])
    if isinstance(tree, dict):
        parts, leaves = [], []
        for k in sorted(tree):
            tag, sub = _flatten(tree[k])
            parts.append(f"{k!r}: {tag}")
            leaves += sub
        return "{" + ", ".join(parts) + "}", leaves
    if isinstance(tree, (list, tuple)):
        parts, leaves = [], []
        for x in tree:
            tag, sub = _flatten(x)
            parts.append(tag)
            leaves += sub
        return f"{type(tree).__name__}[" + ", ".join(parts) + "]", leaves
    return "*", [tree]


def _unflatten(like, leaves):
    """``like``'s structure filled with ``leaves`` (consumed in order)."""
    if isinstance(like, SimState):
        return SimState(**{f: leaves.pop(0) for f in _STATE_FIELDS})
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return leaves.pop(0)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save(path: str, state, mesh=None, engine: str | None = None) -> None:
    """Write a state (SimState, or a dict / list / tuple of tensors);
    optionally stamp the mesh's identity and the engine's name."""
    tag, leaves = _flatten(state)
    leaves = [_host(x) for x in leaves]
    meta = {"structure": tag, "shapes": [list(x.shape) for x in leaves]}
    if engine is not None:
        meta["engine"] = engine
    if mesh is not None:
        meta["num_particles"] = int(mesh.num_particles)
        meta["num_tets"] = int(mesh.num_tets)
        meta["mesh_hash"] = mesh_fingerprint(mesh)
    np.savez_compressed(
        path,
        __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **{f"leaf{i}": x for i, x in enumerate(leaves)},
    )


def _read_meta(z) -> dict:
    if "__meta__" in z.files:
        return json.loads(bytes(z["__meta__"]).decode())
    if "__treedef__" in z.files:  # the JAX package's oldest files
        return {"treedef": bytes(z["__treedef__"]).decode()}
    return {}


def load(path: str, like=None, mesh=None, engine: str | None = None,
         device=None):
    """Read a checkpoint onto ``device`` (default: that of ``like``'s first
    tensor leaf, else the card).

    ``like``: a state of the target structure; the stored structure tag
    (when the port wrote it) and the leaf shapes are checked against it.
    ``mesh`` / ``engine``: checked against the stamped identity where the
    file has one.  Without ``like`` a SimState is assumed."""
    with np.load(path) as z:
        meta = _read_meta(z)
        n = sum(1 for k in z.files if k.startswith("leaf"))
        leaves = [z[f"leaf{i}"] for i in range(n)]

    if engine is not None and meta.get("engine") not in (None, engine):
        raise ValueError(
            f"checkpoint was written by engine {meta['engine']!r}, "
            f"not {engine!r}")
    if "shapes" in meta:  # corruption / partial-write guard
        got = [list(x.shape) for x in leaves]
        if got != meta["shapes"]:
            raise ValueError(
                f"checkpoint leaves {got} disagree with their own stamped "
                f"shapes {meta['shapes']} — file corrupt or truncated")
    if mesh is not None:
        if "mesh_hash" in meta:
            if (meta["num_particles"] != mesh.num_particles
                    or meta["num_tets"] != mesh.num_tets
                    or meta["mesh_hash"] != mesh_fingerprint(mesh)):
                raise ValueError(
                    "checkpoint does not match this mesh: stored "
                    f"{meta['num_particles']} particles / {meta['num_tets']} "
                    f"tets (hash {meta['mesh_hash']}), got "
                    f"{mesh.num_particles} / {mesh.num_tets} "
                    f"(hash {mesh_fingerprint(mesh)})")
        elif leaves and leaves[0].shape[0] != mesh.num_particles:
            # unstamped: the first leaf (pos of a SimState) gives the count
            raise ValueError(
                f"checkpoint first leaf has {leaves[0].shape[0]} rows, mesh "
                f"has {mesh.num_particles} particles")

    if like is not None:
        tag, want_leaves = _flatten(like)
        stored = meta.get("structure")
        if stored is not None and stored != tag:
            raise ValueError(
                "checkpoint structure does not match `like`:\n"
                f"  stored: {stored}\n  target: {tag}")
        want = [tuple(np.shape(x)) for x in want_leaves]
        got = [tuple(x.shape) for x in leaves]
        if want != got:
            raise ValueError(
                f"checkpoint leaf shapes {got} do not match target {want}")
        if device is None:
            device = next((x.device for x in want_leaves if torch.is_tensor(x)),
                          "cuda")
    elif len(leaves) != 4:
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves; a bare SimState needs 4 "
            "(pass `like=` for other structures)")
    device = check_device("cuda" if device is None else device)
    tensors = [torch.as_tensor(x).to(device) for x in leaves]
    return SimState(*tensors) if like is None else _unflatten(like, tensors)


# ---------------------------------------------------------------------------
# Scene checkpoint
# ---------------------------------------------------------------------------

SCENE_VERSION = 1

_PARAM_LEAVES = (
    "gravity", "time_scale", "time_step", "friction", "density",
    "dev_compliance", "vol_compliance", "world_min", "world_max",
)
_MESH_FIELDS = ("verts", "tets", "edges", "vis_tet_ids", "vis_bary", "tris")


def _params_to_meta(p: PhysicsParams) -> dict:
    m = {k: np.asarray(getattr(p, k)).tolist() for k in _PARAM_LEAVES}
    m["num_substeps"] = int(p.num_substeps)
    m["extract_iters"] = int(p.extract_iters)
    return m


def _params_from_meta(m: dict) -> PhysicsParams:
    return PhysicsParams(**m)


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def _lanes(body) -> int:
    """R, the particle lanes of the JAX kernel's planes for this batch:
    128-padded, and for the coloured kernel at least four corner blocks of
    its widest level (itself 128-padded)."""
    from .kernels.gs_fused import FusedGSBody

    n = body.mesh.num_particles
    if isinstance(body, FusedGSBody):
        c = _round_up(max(body.arrays.slot_valid.shape[1], 1), 128)
        return _round_up(max(n, 4 * c), 128)
    return _round_up(n, 128)


def _planes_from_batch(body) -> np.ndarray:
    """[9, B_pad, R] planes of a fused batch; the padded bodies rest at the
    mesh's vertices, the padded lanes are 0."""
    b, n = body.num_bodies, body.mesh.num_particles
    out = np.zeros((9, _round_up(b, 8), _lanes(body)), np.float32)
    for k, x in enumerate((body.pos, body.prev_pos, body.vel)):
        out[3 * k:3 * k + 3, :b, :n] = np.moveaxis(_host(x), -1, 0)
    rest = body.mesh.verts.astype(np.float32).T[:, None, :]
    out[0:3, b:, :n] = rest
    out[3:6, b:, :n] = rest
    return out


def _grabs_to_planes(body):
    """grab_id [B_pad, 1] and grab_pos [B_pad, 4] of the JAX batches."""
    b = body.num_bodies
    gid = np.full((_round_up(b, 8), 1), -1, np.int32)
    gpos = np.zeros((_round_up(b, 8), 4), np.float32)
    gid[:b] = _host(body.grab_id)
    gpos[:b, :3] = _host(body.grab_pos)[:, 0]
    return gid, gpos


def _polar_perm(mesh) -> np.ndarray:
    """The JAX polar kernel's tet lanes: tets sorted by their first corner."""
    return np.argsort(mesh.tets[:, 0], kind="stable")


def _capture_body(body) -> dict:
    """A scene body's state and grabs as {name: numpy array}, in the JAX
    package's shapes."""
    from .kernels.gs_fused import FusedGSBody
    from .kernels.gs_ordered import OrderedGSBody
    from .kernels.polar_fused import FusedPolarBody
    from .solvers.polar_grid import quats_from_kernel, unplanes
    from .world import (BatchedBody, Body, DenseBody, GridBodyBatch,
                        PackedGridBody)

    if isinstance(body, (Body, PackedGridBody)):
        s, c = body.state, body.controls  # PackedGridBody: unpacked here
        d = {f: _host(getattr(s, f)) for f in _STATE_FIELDS}
        d.update(grab_id=_host(c.grab_id), grab_pos=_host(c.grab_pos))
        return d
    if isinstance(body, BatchedBody):  # one flat mesh, flat grab ids
        n = body.mesh.num_particles
        gid = _host(body.grab_id)[:, 0].astype(np.int32)
        flat = np.where(gid >= 0, gid + n * np.arange(len(gid)), -1)
        if body.quats is None:  # neohookean: the flat state's identity
            quats = np.zeros((body.num_bodies * body.mesh.num_tets, 4),
                             np.float32)
            quats[:, 3] = 1.0
        else:
            quats = _host(body.quats).reshape(-1, 4)
        return {"pos": _host(body.pos).reshape(-1, 3),
                "prev_pos": _host(body.prev_pos).reshape(-1, 3),
                "vel": _host(body.vel).reshape(-1, 3), "quats": quats,
                "grab_id": flat.astype(np.int32),
                "grab_pos": _host(body.grab_pos)[:, 0]}
    if isinstance(body, GridBodyBatch):
        if body.quats is None:
            quats = np.zeros((body.num_bodies, body.arrays.num_tets, 4),
                             np.float32)
            quats[..., 3] = 1.0
        else:
            quats = _host(quats_from_kernel(body.quats))
        return {"pos": _host(unplanes(body.pos)),
                "prev_pos": _host(unplanes(body.prev_pos)),
                "vel": _host(unplanes(body.vel)), "quats": quats,
                "grab_id": _host(body.grab_id)[:, 0],
                "grab_pos": _host(body.grab_pos)[:, 0]}
    if isinstance(body, (FusedGSBody, FusedPolarBody, OrderedGSBody)):
        gid, gpos = _grabs_to_planes(body)
        d = {"planes": _planes_from_batch(body), "grab_id": gid,
             "grab_pos": gpos}
        if isinstance(body, FusedPolarBody):
            m = body.mesh.num_tets
            q = np.zeros((4, d["planes"].shape[1], _round_up(m, 128)),
                         np.float32)
            q[3] = 1.0
            q[:, :body.num_bodies, :m] = np.moveaxis(
                _host(body.quats)[:, _polar_perm(body.mesh)], -1, 0)
            d["quats"] = q
        return d
    if isinstance(body, DenseBody):  # columns: [N, 3, B], grabs [B], [3, B]
        return {k: _host(getattr(body, k))
                for k in ("pos", "prev_pos", "vel", "grab_id", "grab_pos")}
    raise TypeError(f"cannot checkpoint body type {type(body).__name__}")


def _restore_body(body, d: dict, params: PhysicsParams) -> None:
    """Inverse of ``_capture_body`` (``d`` holds numpy arrays)."""
    from .kernels.gs_fused import FusedGSBody
    from .kernels.gs_ordered import OrderedGSBody
    from .kernels.polar_fused import FusedPolarBody
    from .solvers.polar_grid import planes, quats_to_kernel
    from .world import (BatchedBody, Body, DenseBody, GridBodyBatch,
                        PackedGridBody)

    def t(x, dtype=np.float32):
        # C-contiguous for the kernels; np.array keeps a 0-d grab id 0-d
        # (ascontiguousarray makes it 1-d)
        return torch.as_tensor(np.array(x, dtype, order="C")).to(body.device)

    if isinstance(body, (Body, PackedGridBody)):
        if isinstance(body, PackedGridBody):
            body._params = params  # the state setter packs with these
        body.state = SimState(*(t(d[f]) for f in _STATE_FIELDS))
        body.controls = Controls(grab_id=t(d["grab_id"], np.int32),
                                 grab_pos=t(d["grab_pos"]))
        return
    b = body.num_bodies
    if isinstance(body, BatchedBody):
        n, m = body.mesh.num_particles, body.mesh.num_tets
        body.pos, body.prev_pos, body.vel = (
            t(d[k]).reshape(b, n, 3) for k in ("pos", "prev_pos", "vel"))
        if body.quats is not None:
            body.quats = t(d["quats"]).reshape(b, m, 4)
        flat = d["grab_id"].astype(np.int64)
        local = np.where(flat >= 0, flat - n * np.arange(b), -1)
        body.grab_id = t(local[:, None], np.int32)
        body.grab_pos = t(d["grab_pos"][:, None])
    elif isinstance(body, GridBodyBatch):
        body.pos, body.prev_pos, body.vel = (
            planes(t(d[k])) for k in ("pos", "prev_pos", "vel"))
        if body.quats is not None:
            body.quats = quats_to_kernel(t(d["quats"]), body.arrays)
        body.grab_id = t(d["grab_id"][:, None], np.int32)
        body.grab_pos = t(d["grab_pos"][:, None])
        body.last_diag = None
    elif isinstance(body, (FusedGSBody, FusedPolarBody, OrderedGSBody)):
        n = body.mesh.num_particles
        st = np.moveaxis(d["planes"][:, :b, :n], 0, -1)  # [B, N, 9]
        body.pos, body.prev_pos, body.vel = (
            t(st[..., 3 * k:3 * k + 3]) for k in range(3))
        body.grab_id = t(d["grab_id"][:b, :1], np.int32)
        body.grab_pos = t(d["grab_pos"][:b, None, :3])
        if isinstance(body, FusedPolarBody):
            m = body.mesh.num_tets
            q = np.empty((b, m, 4), np.float32)
            q[:, _polar_perm(body.mesh)] = np.moveaxis(
                d["quats"][:, :b, :m], 0, -1)
            body.quats = t(q)
    elif isinstance(body, DenseBody):
        body.pos, body.prev_pos, body.vel = (
            t(d[k]) for k in ("pos", "prev_pos", "vel"))
        body.grab_id = t(d["grab_id"], np.int32)
        body.grab_pos = t(d["grab_pos"])
    else:
        raise TypeError(f"cannot restore body type {type(body).__name__}")


def save_world(world, path: str) -> None:
    """Write a whole World: params, every body's state and the specs."""
    arrays: dict = {}
    bodies_meta = []
    for i, b in enumerate(world.bodies):
        d = _capture_body(b)
        bodies_meta.append({
            "type": type(b).__name__,
            "engine": getattr(b, "engine", type(b).__name__),
            "mesh_hash": mesh_fingerprint(b.mesh),
            "keys": sorted(d),
        })
        arrays.update({f"b{i}.{k}": v for k, v in d.items()})
    specs = [None if s is None else dict(s) for s in world._specs]
    for i, spec in enumerate(specs):
        if spec is None:
            continue
        mesh = spec.pop("_mesh", None)
        if mesh is not None:
            spec["mesh"] = "inline"
            for f in _MESH_FIELDS:
                v = getattr(mesh, f)
                if v is not None:
                    arrays[f"spec{i}.{f}"] = np.asarray(v)
    meta = {
        "scene_version": SCENE_VERSION,
        "params": _params_to_meta(world.params),
        "bodies": bodies_meta,
        "specs": specs,
    }
    np.savez_compressed(
        path,
        __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **arrays,
    )


def _apply_states(world, meta: dict, z) -> None:
    for i, (b, bm) in enumerate(zip(world.bodies, meta["bodies"])):
        if type(b).__name__ != bm["type"]:
            raise ValueError(
                f"scene body {i} is {type(b).__name__}, checkpoint has "
                f"{bm['type']}")
        engine = getattr(b, "engine", type(b).__name__)
        if engine != bm["engine"]:
            raise ValueError(
                f"scene body {i} runs engine {engine!r}, checkpoint has "
                f"{bm['engine']!r}")
        if mesh_fingerprint(b.mesh) != bm["mesh_hash"]:
            raise ValueError(f"scene body {i} mesh differs from checkpoint")
        _restore_body(b, {k: z[f"b{i}.{k}"] for k in bm["keys"]},
                      world.params)


def _world_meta(z, path: str) -> dict:
    meta = _read_meta(z)
    if "bodies" not in meta:
        raise ValueError(f"{path} is not a world checkpoint")
    return meta


def restore_world(world, path: str) -> None:
    """Restore a checkpoint into an existing World with the same scene
    structure (body types, engines, meshes are checked first)."""
    with np.load(path) as z:
        meta = _world_meta(z, path)
        if len(world.bodies) != len(meta["bodies"]):
            raise ValueError(
                f"scene has {len(world.bodies)} bodies, checkpoint has "
                f"{len(meta['bodies'])}")
        world.params = _params_from_meta(meta["params"])
        _apply_states(world, meta, z)


def _spec_mesh(z, i: int):
    from .mesh import TetMesh

    return TetMesh(**{f: z[f"spec{i}.{f}"] for f in _MESH_FIELDS
                      if f"spec{i}.{f}" in z.files})


def load_world(path: str, device="cuda"):
    """Rebuild a World on ``device`` from a scene checkpoint: replay each
    body's construction spec, then restore the params and every body's
    state."""
    from .world import World

    with np.load(path) as z:
        meta = _world_meta(z, path)
        specs = meta.get("specs", [])
        if len(specs) != len(meta["bodies"]):
            raise ValueError(
                "checkpoint bodies lack construction specs (added outside "
                "the World.add_* calls?): rebuild the scene in code and use "
                "restore_world / world.restore instead")
        world = World(_params_from_meta(meta["params"]), device=device)
        adders = {"body": world.add_body, "grid_body": world.add_grid_body,
                  "grid_body_batch": world.add_grid_body_batch,
                  "body_batch": world.add_body_batch}
        for i, spec in enumerate(specs):
            if spec is None:
                raise ValueError(
                    f"body {i} has no construction spec (prebuilt arrays): "
                    "rebuild the scene in code and use restore_world / "
                    "world.restore instead")
            spec = dict(spec)
            kind = spec.pop("add")
            if kind not in adders:
                raise ValueError(f"unknown body spec kind {kind!r}")
            if spec.pop("mesh", None) == "inline":
                spec["mesh"] = _spec_mesh(z, i)
            spec.pop("color_scan", None)  # a JAX compile-time flag
            adders[kind](**spec)
        _apply_states(world, meta, z)
    return world
