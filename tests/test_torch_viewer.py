"""tetsim_torch's viewer server (``viewer/server.py``) live on the CPU: the
same blobs as tetsim_tpu's server for the same world, the browser client's
decoding of them, grabs, params, reset and the sim-error overlay; and the
fused step+export of ``Body`` against the JAX package's."""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import tetsim_tpu as ts
import tetsim_torch as tt
from tests.test_client_protocol import (JSRangeError, _client_decode_mesh,
                                        _client_decode_state)
from tetsim_tpu.viewer import ViewerServer as JaxViewerServer
from tetsim_torch.viewer import ViewerServer
from tetsim_torch.world import Body, _surface_render_data

# One torch thread per process: the suite runs a process per core, and
# torch's own thread pool on top of that spends the cores spinning.
torch.set_num_threads(1)

SMALL = dict(cell=0.25, origin=(-0.375, 0.5, -0.375))  # conftest's small_mesh
N_VIS, N_PART, N_TRIS, N_EDGES = 29800, 1234, 59657, 6222  # the dragon


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as r:
        return r.read()


def _post(port, path, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(obj).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _split(blob):
    nl = blob.index(b"\n")
    return json.loads(blob[:nl]), blob[nl + 1:]


def _wait_frames(srv, n=2):
    """Wait (up to 60 s) until the sim thread has stepped ``n`` more
    frames."""
    start, deadline = srv.frame, time.time() + 60
    while srv.frame < start + n and time.time() < deadline:
        time.sleep(0.05)
    assert srv.frame >= start + n, "the sim thread stalled"


def _dragon_world():
    world = tt.World(tt.PhysicsParams(num_substeps=2), device="cpu")
    world.add_body(tt.load_dragon(), engine="polar")
    return world


@pytest.fixture(scope="module")
def server():
    srv = ViewerServer(_dragon_world(), port=0, fps=30.0).start()
    yield srv
    srv.stop()


def test_blobs_equal_jax_server(server):
    """/mesh is byte for byte the JAX server's; the rest state's /state
    payload matches it within 1e-5 (its header exactly)."""
    jw = ts.World(ts.PhysicsParams(num_substeps=2))
    jw.add_body(ts.load_dragon(), engine="polar")
    jsrv = JaxViewerServer(jw)  # not started: methods driven directly
    assert _get(server.port, "/mesh") == jsrv.mesh_blob()
    rest = ViewerServer(_dragon_world())
    jh, jp = _split(jsrv.state_blob())
    th, tp = _split(rest.state_blob())
    assert th == jh and len(tp) == len(jp) == 4 * 3 * (2 * N_VIS + N_PART)
    np.testing.assert_allclose(np.frombuffer(tp, "<f4"),
                               np.frombuffer(jp, "<f4"), atol=1e-5)


def test_client_decodes_blobs(server):
    """The client's own parsing (tests/test_client_protocol.py) on the
    port's blobs: headers, alignment, counts consumed exactly, and a
    corrupted header breaks the decode."""
    mesh_info, tris, edges = _client_decode_mesh(_get(server.port, "/mesh"))
    assert (mesh_info["n_vis"], mesh_info["n_particles"], mesh_info["n_tris"],
            mesh_info["n_edges"]) == (N_VIS, N_PART, N_TRIS, N_EDGES)
    assert int(tris.max()) < N_VIS and int(edges.max()) < N_PART
    blob = _get(server.port, "/state")
    diag, verts, nrms, parts = _client_decode_state(blob, mesh_info)
    assert "frame" in diag
    for a in (verts, nrms, parts):
        assert np.isfinite(a).all()
    lens = np.linalg.norm(nrms.reshape(-1, 3), axis=1)
    assert (np.abs(lens - 1.0) < 1e-3).mean() > 0.99
    nl = blob.index(b"\n")
    assert (nl + 1) % 4 == 0
    assert len(blob) - (nl + 1) == (2 * N_VIS * 3 + N_PART * 3) * 4
    with pytest.raises(JSRangeError):
        _client_decode_state(blob, dict(mesh_info, n_vis=N_VIS + 1))
    with pytest.raises(JSRangeError):
        _client_decode_state(blob[:nl + 1] + blob[nl + 2:], mesh_info)
    assert b"webgl2" in _get(server.port, "/").lower()


def test_state_advances_and_grab_round_trip(server):
    h1, _ = _split(_get(server.port, "/state"))
    pos = server.body.positions
    c = pos.mean(axis=0)
    origin = c + np.float32([0.0, 0.5, 2.0])
    d = (c - origin) / np.linalg.norm(c - origin)
    gid = _post(server.port, "/grab", {"action": "start",
                                       "origin": origin.tolist(),
                                       "dir": d.tolist()})["grabbed"]
    assert 0 <= gid < N_PART
    out = _post(server.port, "/grab", {
        "action": "move", "origin": (origin + [0.0, 0.6, 0.0]).tolist(),
        "dir": d.tolist()})
    assert out["grabbed"] == gid
    _wait_frames(server)
    deadline = time.time() + 60  # /state serves the frame before the last
    while time.time() < deadline:
        hdr, _ = _split(_get(server.port, "/state"))
        if hdr["grabbed"] == gid:
            break
        time.sleep(0.05)
    assert hdr["grabbed"] == gid and hdr["frame"] > h1["frame"]
    with server._lock:  # the solver holds the particle on its target
        b = server.body
        assert torch.equal(b.state.pos[gid], b.controls.grab_pos)
    assert _post(server.port, "/grab", {"action": "end"})["grabbed"] == -1
    assert _post(server.port, "/grab", {"action": "start", "origin": [50, 50, 50],
                                        "dir": [0, 1, 0]})["grabbed"] == -1


def test_bad_requests_are_400(server):
    for msg in ({"action": "start", "origin": [0, 1, 3]},
                {"action": "move", "dir": [0, 0, -1]}):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(server.port, "/grab", msg)
        assert exc.value.code == 400
        body = json.loads(exc.value.read())
        assert "origin" in body["error"] and "dir" in body["error"]
    for msg in ({"not_a_param": 1}, {"normals": "flat"}):
        with pytest.raises(urllib.error.HTTPError):
            _post(server.port, "/params", msg)
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}/grab",
                                 data=b"{not json", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=120)
    assert e.value.code == 400


def test_params_reset_and_rotated_normals(server):
    """Params land with their types; POST /params {"normals": "rotated"}
    switches the polar body to rotated rest normals (unit length); reset
    drops the grab; /diag answers."""
    _post(server.port, "/params", {"gravity": -1.0})
    assert server.world.params.gravity == np.float32(-1.0)
    _post(server.port, "/params", {"num_substeps": 3, "extract_iters": 2})
    assert type(server.world.params.extract_iters) is int
    _post(server.port, "/params", {"num_substeps": 2, "extract_iters": 9,
                                   "gravity": -9.81, "normals": "rotated"})
    deadline = time.time() + 10
    while time.time() < deadline:
        hdr, payload = _split(_get(server.port, "/state"))
        if hdr["normals"] == "rotated":
            break
        time.sleep(0.1)
    assert hdr["normals"] == "rotated"
    nrm = np.frombuffer(payload[N_VIS * 12:2 * N_VIS * 12], "<f4").reshape(-1, 3)
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=-1), 1.0, atol=1e-3)
    _post(server.port, "/params", {"normals": "smooth"})
    _post(server.port, "/reset", {})
    assert int(server.body.controls.grab_id) == -1
    diag = json.loads(_get(server.port, "/diag"))
    assert not diag["body0"]["nan"]


def test_ordered_body_renders_and_grabs():
    """An OrderedGSBody renders through /mesh and /state, and a grab ray
    goes to the owning body's slot (tests/test_viewer.py)."""
    mesh = tt.with_boundary_surface(tt.grid_mesh(3, 3, 3, **SMALL))
    world = tt.World(tt.PhysicsParams(num_substeps=1), device="cpu")
    body = world.add_body_batch(mesh, 8, engine="neohookean",
                                backend="fused_ordered", jitter=0.05)
    srv = ViewerServer(world, port=0, fps=20.0).start()
    try:
        hdr, _ = _split(_get(srv.port, "/mesh"))
        s_per = mesh.vis_tet_ids.shape[0]
        assert hdr["n_vis"] == 8 * s_per
        assert hdr["n_tris"] == 8 * mesh.tris.shape[0]
        _, payload = _split(_get(srv.port, "/state"))
        assert np.isfinite(np.frombuffer(payload[:8 * s_per * 12], "<f4")).all()
        c = body.positions().reshape(-1, 3).mean(axis=0)
        origin = c + np.float32([0.0, 0.3, 1.5])
        d = (c - origin) / np.linalg.norm(c - origin)
        out = _post(srv.port, "/grab", {"action": "start",
                                        "origin": origin.tolist(),
                                        "dir": d.tolist()})
        assert out["grabbed"] >= 0
        owner, local = divmod(out["grabbed"], mesh.num_particles)
        assert int(body.grab_id[owner, 0]) == local
        _post(srv.port, "/grab", {"action": "move", "dir": d.tolist(),
                                  "origin": (origin + [0, 0.4, 0]).tolist()})
        _wait_frames(srv)
        with srv._lock:
            assert torch.equal(body.pos[owner, local], body.grab_pos[owner, 0])
        _post(srv.port, "/grab", {"action": "end"})
        assert int(body.grab_id[owner, 0]) == -1
    finally:
        srv.stop()


def test_sim_error_surfaces_to_client():
    """A sim-thread exception stops the thread and reaches every later
    /state header and /diag answer; before the first frame the error blob
    has the full payload size and no device work."""
    srv = ViewerServer(_dragon_world(), port=0, fps=30.0)

    def boom(*a, **k):
        raise RuntimeError("injected solver failure")

    srv.views[0].body.step_many_export = boom
    srv.start()
    try:
        srv._sim_thread.join(timeout=10)
        assert not srv._sim_thread.is_alive()
        assert "injected solver failure" in srv.sim_error
        assert srv._cached_state is None
        hdr, payload = _split(_get(srv.port, "/state"))
        assert "injected solver failure" in hdr["error"]
        assert len(payload) == 4 * 3 * (2 * srv._n_vis + srv._n_part)
        diag = json.loads(_get(srv.port, "/diag"))
        assert "injected solver failure" in diag["error"]
    finally:
        srv.stop()


@pytest.mark.parametrize("engine", ["polar", "neohookean"])
def test_step_many_export_matches_jax(engine):
    """Body.step_many_export on the boundary surface of small_mesh: one
    frame + export against the JAX package's at 2e-5 (rotated normals too
    for polar), and equal to the port's own step + separate export."""
    from tetsim_tpu.mesh import with_boundary_surface as jax_surface
    from tetsim_tpu.world import Body as JaxBody

    jbody = JaxBody(jax_surface(ts.grid_mesh(3, 3, 3, **SMALL)), engine=engine)
    mesh = tt.with_boundary_surface(tt.grid_mesh(3, 3, 3, **SMALL))
    body, seq = Body(mesh, engine=engine, device="cpu"), Body(
        mesh, engine=engine, device="cpu")
    jbody.enable_render_export()
    body.enable_render_export()
    p, jp = tt.PhysicsParams(num_substeps=2), ts.PhysicsParams(num_substeps=2)
    vn = body.step_many_export(p, frames=1)
    jvn = np.asarray(jbody.step_many_export(jp, frames=1))
    np.testing.assert_allclose(vn.numpy(), jvn, atol=2e-5)
    seq.step(p)
    s = seq._surface
    assert torch.equal(vn, _surface_render_data(seq.state.pos, s.skin_ids,
                                                s.skin_w, s.tris))
    if engine == "polar":
        rot = body.step_many_export(p, frames=1, normals="rotated")
        jrot = np.asarray(jbody.step_many_export(jp, frames=1, normals="rotated"))
        np.testing.assert_allclose(rot.numpy(), jrot, atol=2e-5)
        np.testing.assert_allclose(np.linalg.norm(rot[1].numpy(), axis=-1),
                                   1.0, atol=1e-5)


def test_reference_api_aliases():
    """Body.simulate(dt) is one substep of length dt and end_frame gives the
    render buffers (tests/test_world.py); _Surface.render_data is the
    [2,S,3] export in one transfer."""
    body = Body(tt.load_dragon(), coloring="greedy", device="cpu")
    ref = Body(tt.load_dragon(), coloring="greedy", device="cpu")
    body.simulate(1.0 / 300.0, tt.default_cpu_params())
    ref.step(tt.PhysicsParams(num_substeps=1, time_step=1.0 / 300.0))
    assert torch.equal(body.state.pos, ref.state.pos)
    pos, surface = body.end_frame()
    assert pos.shape == (N_PART, 3) and surface.shape == (N_VIS, 3)
    assert np.isfinite(pos).all()
    vn = body._surface.render_data(body.state.pos)
    np.testing.assert_array_equal(vn[0], surface)
    assert vn.shape == (2, N_VIS, 3)
