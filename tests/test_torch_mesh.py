"""Port parity for triangle-mesh assets and the native URDF compiler: the
STL (binary and ASCII) and OBJ loaders, vertex-clustering decimation,
``triangles_to_frames``, the URDF mesh branch (resolved, ``package://``,
unresolved), a mesh scene's tables, its plain ray cast against the JAX
oracle (``ops/raycast.raycast_batched``) and its collision SDF, and the
native compiler (``csrc/scene_compiler.cpp``, built here by the host C++
compiler) against the Python parser on every procedural asset, its
routing, the models it declines and a failed build.

Tolerances:
  * loaders and decimation: vertices and faces equal to JAX's (the same
    numpy code);
  * triangles_to_frames and the mesh branch's primitives: 1e-6;
  * scene tables: integer leaves exact, float leaves 1e-6;
  * the mesh scene's ray cast: depth atol 2e-3, seg agreement > 0.999 on
    hit rays (the bar of tests/test_torch_raycast.py);
  * the SDF against JAX's: 1e-5; against the analytic sphere: the
    tessellation's error (the sphere's radius less its nearest face
    plane's distance, < 0.03 m);
  * native compiler against the Python parser: mass 1e-5, com and inertia
    1e-5, bound radius 1e-4, primitives 1e-6 (the bars of
    tests/test_native_loader.py); port against JAX native: equal.
"""

import os
import struct
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aerial_gym_simulator_tpu  # noqa: F401  (registers the JAX configs)
from aerial_gym_simulator_tpu.assets import mesh as j_mesh
from aerial_gym_simulator_tpu.assets import native_loader as j_native
from aerial_gym_simulator_tpu.assets import urdf as j_urdf
from aerial_gym_simulator_tpu.config.asset_config import env_object_config as j_eoc
from aerial_gym_simulator_tpu.config.env_config import obstacle_envs as j_envs
from aerial_gym_simulator_tpu.envs import collision as j_collision
from aerial_gym_simulator_tpu.envs import scene as j_scene
from aerial_gym_simulator_tpu.ops import raycast as j_oracle
from aerial_gym_simulator_tpu.sim.sim_builder import SimBuilder as JSimBuilder
from aerial_gym_simulator_tpu.utils.math import quat_rotate as j_quat_rotate

import aerial_gym_simulator_tpu_torch  # noqa: F401
from aerial_gym_simulator_tpu_torch.assets import mesh as t_mesh
from aerial_gym_simulator_tpu_torch.assets import native_loader as t_native
from aerial_gym_simulator_tpu_torch.assets import procedural as t_proc
from aerial_gym_simulator_tpu_torch.assets import urdf as t_urdf
from aerial_gym_simulator_tpu_torch.config.asset_config import env_object_config as t_eoc
from aerial_gym_simulator_tpu_torch.config.env_config import obstacle_envs as t_envs
from aerial_gym_simulator_tpu_torch.config.robot_config import reconfigurable_urdf
from aerial_gym_simulator_tpu_torch.envs import collision as t_collision
from aerial_gym_simulator_tpu_torch.envs import scene as t_scene
from aerial_gym_simulator_tpu_torch.ops import raycast_cuda as rc
from aerial_gym_simulator_tpu_torch.ops._build import HostLibrary
from aerial_gym_simulator_tpu_torch.registry.registries import robot_registry
from aerial_gym_simulator_tpu_torch.sim.convert import (
    params_from_numpy, record_to_numpy, state_from_numpy)


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """These tests run many eager ops on small tensors; torch's intra-op
    threads buy them little and, when several test workers share the cores,
    their spinning costs minutes. One thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


RADIUS = 0.8


def _icosphere(subdiv=2, radius=1.0):
    """Subdivided icosahedron (verts, faces)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], float)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    for _ in range(subdiv):
        mid, verts = {}, list(v)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                mid[key] = len(verts)
                verts.append(m / np.linalg.norm(m))
            return mid[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v, f = np.asarray(verts), np.asarray(nf)
    return v * radius, f


def _write_binary_stl(path, verts, faces):
    with open(path, "wb") as fh:
        fh.write(b"\0" * 80)
        fh.write(struct.pack("<I", len(faces)))
        for tri in faces:
            fh.write(struct.pack("<3f", 0, 0, 0))
            for vi in tri:
                fh.write(struct.pack("<3f", *verts[vi]))
            fh.write(struct.pack("<H", 0))


def _write_ascii_stl(path, verts, faces):
    with open(path, "w") as fh:
        fh.write("solid sphere\n")
        for tri in faces:
            fh.write("  facet normal 0 0 0\n    outer loop\n")
            for vi in tri:
                fh.write("      vertex {:.7f} {:.7f} {:.7f}\n".format(*verts[vi]))
            fh.write("    endloop\n  endfacet\n")
        fh.write("endsolid sphere\n")


def _write_obj(path, verts, faces):
    with open(path, "w") as fh:
        for vv in verts:
            fh.write(f"v {vv[0]} {vv[1]} {vv[2]}\n")
        for ff in faces:
            fh.write(f"f {ff[0] + 1} {ff[1] + 1} {ff[2] + 1}\n")


def _mesh_urdf(filename, scale="1 1 1", xyz="0 0 0"):
    return f"""<?xml version="1.0"?>
<robot name="meshobj">
  <link name="base_link">
    <inertial><mass value="1.0"/>
      <inertia ixx="0.1" ixy="0" ixz="0" iyy="0.1" iyz="0" izz="0.1"/>
    </inertial>
    <collision>
      <origin xyz="{xyz}" rpy="0.1 0.2 0.3"/>
      <geometry><mesh filename="{filename}" scale="{scale}"/></geometry>
    </collision>
  </link>
</robot>
"""


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshes")
    v, f = _icosphere(2, RADIUS)
    paths = {"stl": str(d / "sphere.stl"), "ascii": str(d / "sphere_ascii.stl"),
             "obj": str(d / "sphere.obj")}
    _write_binary_stl(paths["stl"], v, f)
    _write_ascii_stl(paths["ascii"], v, f)
    _write_obj(paths["obj"], v, f)
    v4, f4 = _icosphere(4, 1.0)
    paths["hipoly"] = str(d / "hipoly.stl")
    _write_binary_stl(paths["hipoly"], v4, f4)
    return d, paths, v, f


@pytest.mark.parametrize("fmt", ["stl", "ascii", "obj"])
def test_loaders_roundtrip_equal_to_jax(meshes, fmt):
    _, paths, v, f = meshes
    tv, tf = t_mesh.load_mesh(paths[fmt])
    jv, jf = j_mesh.load_mesh(paths[fmt])
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert len(tf) == len(f) and len(tv) == len(v)
    np.testing.assert_allclose(np.linalg.norm(tv, axis=1), RADIUS, atol=1e-5)


def test_unsupported_format_raises(tmp_path):
    with pytest.raises(ValueError, match="unsupported mesh format"):
        t_mesh.load_mesh(str(tmp_path / "blob.ply"))


@pytest.mark.parametrize("budget", [64, 512])
def test_decimation_equal_to_jax(meshes, budget):
    _, paths, _, _ = meshes
    v, f = t_mesh.load_mesh(paths["hipoly"])
    assert len(f) == 5120
    tv, tf = t_mesh.decimate_vertex_clustering(v, f, budget)
    jv, jf = j_mesh.decimate_vertex_clustering(v, f, budget)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert 0 < len(tf) <= budget
    assert np.linalg.norm(tv, axis=1).max() <= 1.01


def test_triangles_to_frames_equal_to_jax(meshes):
    _, paths, _, _ = meshes
    v, f = t_mesh.load_mesh(paths["stl"])
    # a degenerate face is dropped on both sides
    f = np.concatenate([f, [[0, 0, 1]]])
    for a, b in zip(t_mesh.triangles_to_frames(v, f), j_mesh.triangles_to_frames(v, f)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    v0, rot, size = t_mesh.triangles_to_frames(v, f)
    assert len(v0) == len(f) - 1
    # the frames rebuild the vertices: v0 + R (a, 0, 0) and v0 + R (b, c, 0)
    np.testing.assert_allclose(v0 + rot[:, :, 0] * size[:, :1], v[f[:-1, 1]], atol=1e-9)
    np.testing.assert_allclose(v0 + rot[:, :, 0] * size[:, 1:2] + rot[:, :, 1] * size[:, 2:3],
                               v[f[:-1, 2]], atol=1e-9)


def test_mesh_to_triangle_prims_with_budget_equal_to_jax(meshes):
    _, paths, _, _ = meshes
    t = t_mesh.mesh_to_triangle_prims(paths["hipoly"], scale=(1.0, 2.0, 0.5), budget=512)
    j = j_mesh.mesh_to_triangle_prims(paths["hipoly"], scale=(1.0, 2.0, 0.5), budget=512)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert 128 < len(t[0]) <= 512
    assert t_mesh.DEFAULT_TRIANGLE_BUDGET == int(
        os.environ.get("AERIAL_GYM_TPU_MESH_TRIANGLE_BUDGET", "2048"))


def _same_models(a, b, exact=False):
    assert len(a.primitives) == len(b.primitives)
    tol = dict(atol=0.0) if exact else dict(atol=1e-6)
    assert abs(a.mass - b.mass) <= (0.0 if exact else 1e-5)
    np.testing.assert_allclose(a.com, b.com, atol=0.0 if exact else 1e-5)
    np.testing.assert_allclose(a.inertia, b.inertia, atol=0.0 if exact else 1e-5)
    assert abs(a.bound_radius - b.bound_radius) <= (0.0 if exact else 1e-4)
    for pa, pb in zip(a.primitives, b.primitives):
        assert pa.kind == pb.kind and pa.semantic_id == pb.semantic_id
        np.testing.assert_allclose(pa.size, pb.size, **tol)
        np.testing.assert_allclose(pa.xyz, pb.xyz, **tol)
        np.testing.assert_allclose(pa.rot, pb.rot, **tol)


@pytest.mark.parametrize("ref", ["same_dir", "package", "absolute"])
def test_urdf_mesh_branch_resolved_equal_to_jax(meshes, ref):
    d, paths, _, f = meshes
    name = {"same_dir": "sphere.stl", "package": "package://my_pkg/meshes/sphere.stl",
            "absolute": paths["stl"]}[ref]
    up = os.path.join(d, f"mesh_{ref}.urdf")
    with open(up, "w") as fh:
        fh.write(_mesh_urdf(name, scale="1.0 1.5 0.5", xyz="0.2 0 0.1"))
    assert t_urdf._resolve_mesh_path(name, up) == j_urdf._resolve_mesh_path(name, up)
    t_model, j_model = t_urdf.load_urdf(up), j_urdf.load_urdf(up)
    assert [p.kind for p in t_model.primitives] == ["triangle"] * len(f)
    _same_models(t_model, j_model)


def test_urdf_mesh_branch_unresolved_is_a_box(meshes):
    text = _mesh_urdf("missing/blob.stl", scale="2 3 4")
    t_model = t_urdf.load_urdf_string(text, name="<string>")
    j_model = j_urdf.load_urdf_string(text, name="<string>")
    assert [p.kind for p in t_model.primitives] == ["box"]
    np.testing.assert_allclose(t_model.primitives[0].size, [0.2, 0.3, 0.4])
    _same_models(t_model, j_model)
    assert t_urdf._resolve_mesh_path("", "x.urdf") is None


def _mesh_env_cfg(eoc, envs, stl):
    asset = eoc.AssetTypeConfig(name="user_mesh_blobs", num_assets=1,
                                urdf_variants=[_mesh_urdf(stl)],
                                min_state_ratio=eoc._ratio(0.35, 0.2, 0.3),
                                max_state_ratio=eoc._ratio(0.85, 0.8, 0.7),
                                keep_in_env=True, semantic_id=42)
    cfg = envs.EnvWithObstaclesConfig()
    cfg.asset_types = list(cfg.asset_types) + [asset]
    cfg.__post_init__()
    return cfg


MESH_PRIMS = 96           # a mesh variant keeps its first 96 triangles


@pytest.fixture(scope="module")
def mesh_scene(meshes):
    _, paths, _, _ = meshes
    j_sc = j_scene.build_scene_params(_mesh_env_cfg(j_eoc, j_envs, paths["stl"]), 2,
                                      max_prims=MESH_PRIMS)
    t_sc = t_scene.build_scene_params(_mesh_env_cfg(t_eoc, t_envs, paths["stl"]), 2, "cpu",
                                      max_prims=MESH_PRIMS)
    jenv = JSimBuilder().build_env("base_sim", "env_with_obstacles", "base_quadrotor",
                                   "lee_velocity_control", num_envs=2, seed=1)
    jp = jenv.params.replace(scene=j_sc)
    js = jenv.state
    js = js.replace(obstacle_pos=jnp.zeros((2, j_sc.num_assets, 3)),
                    obstacle_quat=jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 1.0]),
                                           (2, j_sc.num_assets, 1)))
    from aerial_gym_simulator_tpu.envs.scene import reset_obstacles
    import jax
    js = reset_obstacles(jp, js, jnp.ones((2,)), jax.random.PRNGKey(0)[None].repeat(2, 0))
    return j_sc, t_sc, jp, js


def test_mesh_scene_tables_equal(mesh_scene):
    j_sc, t_sc, _, _ = mesh_scene
    _leaves = record_to_numpy(t_sc), record_to_numpy(j_sc)
    for k, ref in _leaves[1].items():
        got = _leaves[0][k]
        if isinstance(ref, np.ndarray) and ref.dtype.kind in "iu":
            np.testing.assert_array_equal(got, ref, err_msg=k)
        elif isinstance(ref, np.ndarray):
            np.testing.assert_allclose(got, ref, atol=1e-6, err_msg=k)
        else:
            assert got == ref, k
    assert t_sc.n_tri == MESH_PRIMS


def test_mesh_scene_plain_raycast_matches_jax(mesh_scene):
    """The port's plain ray cast (what CPU tensors run) against the JAX
    oracle on the mesh scene, rays aimed at the mesh asset."""
    _, _, jp, js = mesh_scene
    # the other obstacles parked, so that every ray can reach the mesh
    mesh_slot = int(np.nonzero(np.asarray(jp.scene.semantic_id) == 42)[0][0])
    others = np.arange(jp.scene.num_assets) != mesh_slot
    js = js.replace(obstacle_pos=js.obstacle_pos.at[:, others].set(-1000.0))
    tp = params_from_numpy(record_to_numpy(jp), "cpu")
    ts = state_from_numpy(record_to_numpy(js), "cpu")
    sc = tp.scene
    # the sensor 2.5 m from the mesh's centre, looking at it
    centre = ts.obstacle_pos[:, mesh_slot]
    origin = centre + torch.tensor([-2.5, 0.3, -0.2])
    quat = torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(2, 4).contiguous()
    ys, xs = np.meshgrid(np.linspace(-0.4, 0.4, 16), np.linspace(-0.4, 0.4, 32),
                         indexing="ij")
    dirs = np.stack([np.ones_like(xs), xs, ys], axis=-1).reshape(-1, 3)
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    depth, seg = rc.raycast(rc.pack_pose(origin, quat),
                            rc.pack_prims_world(sc, ts.obstacle_pos, ts.obstacle_quat),
                            torch.from_numpy(dirs), torch.ones(len(dirs)), sc.n_box, sc.n_cyl,
                            sc.n_sph, 20.0, n_tri=sc.n_tri)
    rd = j_quat_rotate(jnp.asarray(quat.numpy())[:, None, :], jnp.asarray(dirs)[None])
    t_j, s_j = j_oracle.raycast_batched(jp.scene, js.obstacle_pos, js.obstacle_quat,
                                        jnp.asarray(origin.numpy()), rd, 20.0)
    t_j, s_j = np.asarray(t_j), np.asarray(s_j)
    np.testing.assert_allclose(depth.numpy(), t_j, atol=2e-3)
    hit = s_j != -2
    assert (s_j == 42).sum() > 50, "the rays must hit the mesh"
    assert (seg.numpy()[hit] == s_j[hit]).mean() > 0.999


def test_mesh_scene_sdf_sees_the_mesh(meshes):
    """A point 0.1 m outside the sphere mesh reads the surface distance
    within the tessellation's chord error, as the JAX SDF does."""
    _, paths, v, f = meshes
    cfg_t = _mesh_env_cfg(t_eoc, t_envs, paths["stl"])
    cfg_t.asset_types = cfg_t.asset_types[-1:]
    cfg_t.__post_init__()
    cfg_j = _mesh_env_cfg(j_eoc, j_envs, paths["stl"])
    cfg_j.asset_types = cfg_j.asset_types[-1:]
    cfg_j.__post_init__()
    t_sc = t_scene.build_scene_params(cfg_t, 3, "cpu", max_prims=512)
    j_sc = j_scene.build_scene_params(cfg_j, 3, max_prims=512)
    assert t_sc.n_tri == len(f)
    jenv = JSimBuilder().build_env("base_sim", "env_with_obstacles", "base_quadrotor",
                                   "lee_velocity_control", num_envs=3, seed=1)
    jp = jenv.params.replace(scene=j_sc)
    js = jenv.state.replace(obstacle_pos=jnp.zeros((3, 1, 3)),
                            obstacle_quat=jnp.asarray([[[0.0, 0.0, 0.0, 1.0]]] * 3))
    tp = params_from_numpy(record_to_numpy(jp), "cpu")
    ts = state_from_numpy(record_to_numpy(js), "cpu")
    dirs = np.array([[1.0, 0.0, 0.0], [0.3, -0.5, 0.8], [-0.2, 0.9, -0.1]])
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts = ((RADIUS + 0.1) * dirs).astype(np.float32)
    d_t = t_collision.scene_sdf_point(tp, ts, torch.from_numpy(pts)).numpy()
    d_j = np.asarray(j_collision.scene_sdf_point(jp, js, jnp.asarray(pts)))
    np.testing.assert_allclose(d_t, d_j, atol=1e-5)
    # the inscribed polyhedron lies between its faces' planes and the
    # sphere: at most R minus the nearest face plane's distance inside it
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    r_in = np.abs(np.einsum("fi,fi->f", n / np.linalg.norm(n, axis=1, keepdims=True),
                            v[f[:, 0]])).min()
    chord = RADIUS - r_in
    assert chord < 0.03
    assert ((d_t >= 0.1 - 1e-6) & (d_t <= 0.1 + chord)).all(), d_t


ASSET_FACTORIES = ("panel_asset_params", "object_asset_params", "thin_asset_params",
                   "tile_asset_params", "tree_asset_params", "dynamic_object_asset_params",
                   "lidar_nav_panel_asset_params", "lidar_nav_object_asset_params",
                   "left_wall", "right_wall", "front_wall", "back_wall", "bottom_wall",
                   "top_wall")


def _procedural_urdfs():
    """Every procedural URDF of the port: each asset type's variants and
    each robot's frame or articulation."""
    texts = {}
    for name in ASSET_FACTORIES:
        for k, text in enumerate(getattr(t_eoc, name)().urdf_variants):
            texts[f"{name}[{k}]"] = text
    for name in sorted(robot_registry._factories):
        cfg = robot_registry.make(name)
        alloc = cfg.control_allocator_config.allocation_matrix
        texts[f"robot:{name}"] = t_proc.multirotor_urdf(
            name=name, motor_positions=t_proc.motor_layout_from_allocation(alloc))
        if getattr(cfg, "articulation_urdf", None):
            texts[f"articulation:{name}"] = cfg.articulation_urdf
    return texts


PROCEDURAL = _procedural_urdfs()


@pytest.mark.parametrize("per_link", [False, True], ids=["one_id", "per_link"])
def test_native_matches_python_on_every_procedural_asset(per_link):
    for name, text in PROCEDURAL.items():
        native = t_native.load_urdf_string_native(text, name, 7, per_link)
        assert native is not None, name
        python = t_urdf._parse_urdf_tree(ET.fromstring(text), name, 7, per_link)
        _same_models(native, python)
        # the same source in both packages: the same floats
        _same_models(native, j_native.load_urdf_string_native(text, name, 7, per_link),
                     exact=True)


def test_native_batch_matches_python(tmp_path):
    paths = []
    for k, (name, text) in enumerate(sorted(PROCEDURAL.items())[:12]):
        p = tmp_path / f"asset_{k:02d}.urdf"
        p.write_text(text)
        paths.append(str(p))
    models = t_native.load_urdf_batch(paths, num_threads=3)
    assert [m.path for m in models] == paths
    for p, m in zip(paths, models):
        _same_models(m, t_urdf._parse_urdf_tree(ET.parse(p).getroot(), p))
    assert t_native.load_urdf_batch([]) is None


def test_load_urdf_routing(tmp_path, monkeypatch):
    """Primitive-only URDFs take the native compiler (links left empty, as
    in JAX); a mesh, semantic_masked_links or AERIAL_GYM_TPU_NATIVE_LOADER=0
    take the Python parser."""
    text = t_proc.tree_urdf("tree", seed=3)
    p = tmp_path / "tree.urdf"
    p.write_text(text)
    assert t_urdf.load_urdf(str(p)).links == []
    assert t_urdf.load_urdf_string(text).links == []
    masked = t_urdf.load_urdf(str(p), per_link_semantic=True,
                              semantic_masked_links={"crown": 77})
    assert masked.links == ["trunk", "crown", "branch_0", "branch_1", "branch_2"]
    assert [pr.semantic_id for pr in masked.primitives] == [0, 77, 2, 3, 4]
    j_masked = j_urdf.load_urdf(str(p), per_link_semantic=True,
                                semantic_masked_links={"crown": 77})
    _same_models(masked, j_masked)
    monkeypatch.setenv("AERIAL_GYM_TPU_NATIVE_LOADER", "0")
    assert t_urdf.load_urdf(str(p)).links[0] == "trunk"
    assert t_urdf.load_urdf_string(text).links[0] == "trunk"


def test_native_declines_what_it_cannot_hold(tmp_path):
    """More than MAX_PRIMS primitives: the compiler declines the model
    (None) and load_urdf parses it in Python, as in JAX."""
    links = "".join(f'<link name="l{i}"><collision><geometry><sphere radius="0.1"/>'
                    f'</geometry></collision></link>' for i in range(t_native.MAX_PRIMS + 4))
    text = f'<robot name="many">{links}</robot>'
    assert t_native.load_urdf_string_native(text) is None
    p = tmp_path / "many.urdf"
    p.write_text(text)
    assert t_native.load_urdf_native(str(p)) is None
    assert len(t_urdf.load_urdf(str(p)).primitives) == t_native.MAX_PRIMS + 4
    assert t_native.load_urdf_batch([str(p)]) is None
    assert t_native.load_urdf_native(str(tmp_path / "missing.urdf")) is None


def test_failed_host_build_raises_with_the_log(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" int f() { return undefined_name; }\n')
    lib = HostLibrary("broken_for_test", source=src)
    monkeypatch.setattr("aerial_gym_simulator_tpu_torch.ops._build.BUILD_DIR", tmp_path / "b")
    with pytest.raises(RuntimeError, match="undefined_name"):
        lib.load()
    monkeypatch.setattr("aerial_gym_simulator_tpu_torch.ops._build.shutil.which",
                        lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        HostLibrary("other_for_test", source=src).load()
