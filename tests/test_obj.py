"""OBJ parser unit tests: every face-index form the reference resolves
(loadObject.pyx:69-111), fan triangulation (loadObject.pyx:53-67), the V
flip, and a parse of the generated sphere written as an OBJ."""

import textwrap

import numpy as np
import pytest

from opengl_raytracer_tpu.models.obj import load_obj_py


def write_obj(tmp_path, text):
    p = tmp_path / "t.obj"
    p.write_text(textwrap.dedent(text))
    return str(p)


def test_full_face_form(tmp_path):
    path = write_obj(
        tmp_path,
        """\
        v 0 0 0
        v 1 0 0
        v 0 1 0
        vt 0.25 0.5
        vn 0 0 1
        f 1/1/1 2/1/1 3/1/1
        """,
    )
    out = load_obj_py(path)
    assert out.shape == (3, 8)
    np.testing.assert_allclose(out[0], [0, 0, 0, 0, 0, 1, 0.25, 0.5])
    np.testing.assert_allclose(out[1, :3], [1, 0, 0])


def test_v_flip(tmp_path):
    path = write_obj(
        tmp_path,
        """\
        v 0 0 0
        v 1 0 0
        v 0 1 0
        vt 0.2 0.3
        f 1/1 2/1 3/1
        """,
    )
    out = load_obj_py(path)
    # stored v = 1 - file v (loadObject.pyx:109)
    np.testing.assert_allclose(out[:, 6:8], [[0.2, 0.7]] * 3, rtol=1e-6)
    # v/t form gets default normal (0,0,1) (loadObject.pyx:97-102)
    np.testing.assert_allclose(out[:, 3:6], [[0, 0, 1]] * 3)


def test_missing_uv_and_normal_defaults(tmp_path):
    path = write_obj(
        tmp_path,
        """\
        v 0 0 0
        v 1 0 0
        v 0 1 0
        vn 0 1 0
        f 1//1 2//1 3//1
        """,
    )
    out = load_obj_py(path)
    # v//n: uv default (0,0) -> stored (0, 1-0) = (0, 1)
    np.testing.assert_allclose(out[:, 6:8], [[0, 1]] * 3)
    np.testing.assert_allclose(out[:, 3:6], [[0, 1, 0]] * 3)


def test_bare_vertex_form(tmp_path):
    path = write_obj(
        tmp_path,
        """\
        v 0 0 0
        v 1 0 0
        v 0 1 0
        f 1 2 3
        """,
    )
    out = load_obj_py(path)
    np.testing.assert_allclose(out[:, 3:6], [[0, 0, 1]] * 3)
    np.testing.assert_allclose(out[:, 6:8], [[0, 1]] * 3)


def test_fan_triangulation(tmp_path):
    path = write_obj(
        tmp_path,
        """\
        v 0 0 0
        v 1 0 0
        v 1 1 0
        v 0 1 0
        v 0 2 0
        f 1 2 3 4 5
        """,
    )
    out = load_obj_py(path)
    # 5-gon -> 3 triangles by fan: (1,2,3), (1,3,4), (1,4,5)
    assert out.shape == (9, 8)
    np.testing.assert_allclose(out[3, :3], [0, 0, 0])
    np.testing.assert_allclose(out[4, :3], [1, 1, 0])
    np.testing.assert_allclose(out[5, :3], [0, 1, 0])
    np.testing.assert_allclose(out[8, :3], [0, 2, 0])


def test_vertex_with_extra_fields(tmp_path):
    # 'v x y z w' takes the last three floats (loadObject.pyx:113-118)
    path = write_obj(
        tmp_path,
        """\
        v 9 1 2 3
        v 9 4 5 6
        v 9 7 8 9
        f 1 2 3
        """,
    )
    out = load_obj_py(path)
    np.testing.assert_allclose(out[0, :3], [1, 2, 3])


NEG_QUIRK_OBJ = """\
v 1 1 1
v 2 2 2
v 3 3 3
f 0 -1 -2
"""
# The reference indexes pools as pool[int(tok) - 1] (loadObject.pyx:82), so
# "0" -> pool[-1] (last), "-1" -> pool[-2], ... — a Python-wraparound quirk,
# NOT OBJ-spec relative indexing ("-3" would be pool[-4]: an IndexError).


def test_negative_index_quirk_python(tmp_path):
    path = write_obj(tmp_path, NEG_QUIRK_OBJ)
    out = load_obj_py(path)
    np.testing.assert_allclose(out[:, 0], [3, 2, 1])


def test_negative_index_quirk_native(tmp_path):
    from opengl_raytracer_tpu.native import loader

    if loader.get_lib() is None:
        pytest.skip("native parser not built")
    path = write_obj(tmp_path, NEG_QUIRK_OBJ)
    np.testing.assert_array_equal(loader.load_obj_native(path),
                                  load_obj_py(path))


def test_four_field_face_token_gets_defaults(tmp_path):
    # 'v/t/n/x' (4 fields) falls into the defaults branch in the Python
    # twin (len(f) not in {2, 3}); the native parser must match.
    text = """\
v 0 0 0
v 1 0 0
v 0 1 0
vt 0.5 0.5
vn 0 1 0
f 1/1/1/9 2/1/1/9 3/1/1/9
"""
    path = write_obj(tmp_path, text)
    out = load_obj_py(path)
    np.testing.assert_allclose(out[:, 3:6], [[0, 0, 1]] * 3)  # default normal
    np.testing.assert_allclose(out[:, 6:8], [[0, 1]] * 3)  # default uv, V-flipped
    from opengl_raytracer_tpu.native import loader

    if loader.get_lib() is not None:
        np.testing.assert_array_equal(loader.load_obj_native(path), out)


def test_out_of_range_index_fails_both(tmp_path):
    # "-3" -> pool[-4] with a 3-vertex pool: IndexError in the reference
    # and in the Python twin; the native parser reports a parse error.
    path = write_obj(tmp_path, "v 1 1 1\nv 2 2 2\nv 3 3 3\nf -3 1 2\n")
    with pytest.raises(IndexError):
        load_obj_py(path)
    from opengl_raytracer_tpu.native import loader

    if loader.get_lib() is not None:
        with pytest.raises(IOError):
            loader.load_obj_native(path)


def sphere_obj(tmp_path):
    """The generated UV sphere (the reference sphere's 3,968 triangles,
    SURVEY.md C16) written as an OBJ."""
    from assets import write_obj

    from opengl_raytracer_tpu.models.procedural import uv_sphere

    sphere = uv_sphere([0, 0, 0], [0, 0, 0])
    return write_obj(tmp_path / "sphere.obj", sphere), sphere


def test_sphere_asset(tmp_path):
    path, sphere = sphere_obj(tmp_path)
    out = load_obj_py(path)
    assert out.shape == (3968 * 3, 8)
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[:, 0:3], sphere.pos)
    np.testing.assert_array_equal(out[:, 3:6], sphere.normals)


def test_native_matches_python(tmp_path):
    from opengl_raytracer_tpu.native import loader

    if loader.get_lib() is None:
        pytest.skip("native parser not built")
    path, _ = sphere_obj(tmp_path)
    np.testing.assert_array_equal(loader.load_obj_native(path), load_obj_py(path))
