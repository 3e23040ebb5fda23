"""Generated meshes and the default scene built from them: exact triangle
counts, closed and outward-wound surfaces, seed determinism, the blob's
non-convexity, and the scene's totals and placement."""

import numpy as np
import pytest

from opengl_raytracer_tpu.models import procedural
from opengl_raytracer_tpu.models.scene import Scene
from opengl_raytracer_tpu.presets import default_objects

MESHES = {
    "sphere": lambda: procedural.uv_sphere([0, 0, 0], [0, 0, 0]),
    "blob": lambda: procedural.blob([0, 0, 0], [0, 0, 0]),
}


def tris(obj):
    return np.asarray(obj.pos, np.float64).reshape(-1, 3, 3)


@pytest.mark.parametrize("name,count", [("sphere", 3968), ("blob", 23490)])
def test_triangle_counts(name, count):
    assert tris(MESHES[name]()).shape[0] == count


@pytest.mark.parametrize("name", sorted(MESHES))
def test_closed_and_outward(name):
    """Every edge of the soup (matched by vertex position) is shared by
    exactly two triangles, once in each direction, and the enclosed volume
    is positive (counter-clockwise seen from outside)."""
    t = tris(MESHES[name]())
    _, ids = np.unique(np.round(t.reshape(-1, 3), 5), axis=0,
                       return_inverse=True)
    ids = ids.reshape(-1, 3)
    directed = np.concatenate([ids[:, [0, 1]], ids[:, [1, 2]], ids[:, [2, 0]]])
    _, counts = np.unique(directed, axis=0, return_counts=True)
    assert (counts == 1).all()
    _, counts = np.unique(np.sort(directed, axis=1), axis=0, return_counts=True)
    assert (counts == 2).all()
    volume = np.einsum("ij,ij->i", t[:, 0], np.cross(t[:, 1], t[:, 2])).sum() / 6
    assert volume > 0


def test_seed_determinism():
    a = procedural.blob([0, 0, 0], [0, 0, 0], seed=3)
    b = procedural.blob([0, 0, 0], [0, 0, 0], seed=3)
    c = procedural.blob([0, 0, 0], [0, 0, 0], seed=4)
    np.testing.assert_array_equal(a.pos, b.pos)
    np.testing.assert_array_equal(a.normals, b.normals)
    assert np.abs(a.pos - c.pos).max() > 0.05


@pytest.mark.parametrize("name,convex", [("sphere", True), ("blob", False)])
def test_convexity(name, convex):
    """A convex mesh has every vertex behind every face plane; the blob's
    noise relief must put vertices well in front of some faces (real
    concavities, so it can occlude itself)."""
    t = tris(MESHES[name]())
    verts = np.unique(t.reshape(-1, 3), axis=0)
    faces = t[:: max(1, t.shape[0] // 512)]
    n = np.cross(faces[:, 1] - faces[:, 0], faces[:, 2] - faces[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    ahead = ((verts[None] - faces[:, None, 0]) * n[:, None]).sum(-1).max()
    if convex:
        assert ahead < 1e-6
    else:
        assert ahead > 0.1


def test_sphere_is_the_reference_sphere():
    """Unit radius and radial smooth normals, like the reference asset."""
    s = MESHES["sphere"]()
    r = np.linalg.norm(s.pos, axis=1)
    np.testing.assert_allclose(r, 1.0, atol=1e-6)
    np.testing.assert_allclose(s.normals, s.pos / r[:, None], atol=1e-6)


def test_default_scene_totals_and_placement():
    objs = default_objects()
    scene = Scene(objs)
    assert len(objs) == 9
    # blob 23,490 + sphere 3,968 + 7 boxes x 12 = the minidragon scene
    assert scene.total_triangles == 23490 + 3968 + 84 == 27542
    blob = np.asarray(objs[0].pos)
    lo, hi = blob.min(axis=0), blob.max(axis=0)
    np.testing.assert_allclose(lo[1], -24.5, atol=1e-3)  # rests on the floor
    assert 15.0 < hi[2] - lo[2] < 30.0  # about a third of the 60-unit box
    assert lo[0] > -35 and hi[0] < 25 and lo[2] > -30 and hi[2] < 30


def test_named_dragon_obj_still_resolves(tmp_path, monkeypatch):
    """An explicit OBJ name goes through resolve_obj_path; a missing one
    raises instead of falling back to the generated stand-in."""
    from assets import write_obj

    (tmp_path / "mydragon").mkdir()
    write_obj(tmp_path / "mydragon" / "d.obj",
              procedural.blob([0, 0, 0], [0, 0, 0], segments=8, rings=4))
    monkeypatch.setenv("OGLRT_MODELS_PATH", str(tmp_path))
    objs = default_objects("mydragon")
    assert np.asarray(objs[0].pos).shape[0] == 3 * 2 * 8 * 3
    with pytest.raises(FileNotFoundError):
        default_objects("no_such_dragon")
