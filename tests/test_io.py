"""OBJ round-trip + native-vs-Python parser agreement + image IO."""

import numpy as np
import pytest

from ntrace_tpu.io.obj import load_obj, load_scene_cached, save_obj
from ntrace_tpu.io.image import checksum, read_png, tonemap, write_png
from ntrace_tpu.scenes import get_scene


OBJ_SAMPLE = """# sample
mtllib sample.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vn 0 0 1
vn 0 0 1
vn 0 0 1
vn 0 0 1
vn 0 0 1
usemtl red
f 1 2 3 4
usemtl blue
f 1//1 2//2 5//5
f -5/1/1 -4/2/2 -1/5/5
"""

MTL_SAMPLE = """newmtl red
Kd 1 0 0
Ke 0.1 0 0
newmtl blue
Kd 0 0 1
Ns 50
"""


@pytest.fixture
def obj_file(tmp_path):
    (tmp_path / "sample.mtl").write_text(MTL_SAMPLE)
    p = tmp_path / "sample.obj"
    p.write_text(OBJ_SAMPLE)
    return p


class TestPythonParser:
    def test_parse_forms(self, obj_file):
        s = load_obj(obj_file, prefer_native=False)
        assert s.num_verts == 5
        # quad fans into 2 tris + 2 single tris = 4
        assert s.num_tris == 4
        np.testing.assert_array_equal(s.indices[0], [0, 1, 2])
        np.testing.assert_array_equal(s.indices[1], [0, 2, 3])
        np.testing.assert_array_equal(s.indices[2], [0, 1, 4])
        # negative indices resolve relative to current vertex count
        np.testing.assert_array_equal(s.indices[3], [0, 1, 4])
        assert s.materials[s.mat_ids[0]].name == "red"
        assert s.materials[s.mat_ids[0]].diffuse == (1.0, 0.0, 0.0)
        assert s.materials[s.mat_ids[2]].name == "blue"
        assert s.materials[s.mat_ids[2]].glossiness == 50

    def test_roundtrip_export(self, tmp_path):
        scene = get_scene("conference", n_tris=2000)
        p = tmp_path / "x.obj"
        save_obj(scene, p)
        back = load_obj(p, prefer_native=False)
        assert back.num_tris == scene.num_tris
        np.testing.assert_allclose(back.positions, scene.positions, rtol=1e-5)
        np.testing.assert_array_equal(back.indices, scene.indices)

    def test_binary_cache(self, obj_file, tmp_path, monkeypatch):
        monkeypatch.setenv("NTRACE_CACHE", str(tmp_path / "cache"))
        a = load_scene_cached(obj_file)
        b = load_scene_cached(obj_file)  # from cache
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.indices, b.indices)
        assert [m.name for m in a.materials] == [m.name for m in b.materials]


class TestNativeParser:
    def test_native_matches_python(self, tmp_path, monkeypatch):
        from ntrace_tpu.native import native_available

        if not native_available():
            pytest.skip("no g++ toolchain")
        scene = get_scene("fairy", n_tris=3000)
        p = tmp_path / "big.obj"
        save_obj(scene, p)
        py = load_obj(p, prefer_native=False)
        from ntrace_tpu.io.obj import _load_obj_native

        nat = _load_obj_native(p)
        np.testing.assert_allclose(nat.positions, py.positions, rtol=1e-5)
        np.testing.assert_array_equal(nat.indices, py.indices)
        np.testing.assert_array_equal(nat.mat_ids, py.mat_ids)

    def test_native_vt_matches_python(self, tmp_path):
        """Native parser carries per-corner UVs (textured
        OBJs must keep the native fast path)."""
        from ntrace_tpu.native import native_available

        if not native_available():
            pytest.skip("no g++ toolchain")
        from ntrace_tpu.io.obj import _load_obj_native

        p = tmp_path / "tex.obj"
        p.write_text(
            "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
            "vt 0 0\nvt 1 0\nvt 1 1\nvt 0.25 0.75\n"
            "vn 0 0 1\n"
            # quad with v/vt and v/vt/vn forms + a negative-index tri
            "f 1/1 2/2 3/3 4/4\n"
            "f 1/1/1 3/3/1 4/4/1\n"
            "f -4/-4 -2/-2 -1/-1\n"
        )
        py = load_obj(p, prefer_native=False)
        nat = _load_obj_native(p)
        np.testing.assert_array_equal(nat.indices, py.indices)
        assert py.uvs is not None and nat.uvs is not None
        np.testing.assert_allclose(nat.uvs, py.uvs, rtol=1e-6)
        # mixed vt/no-vt corners: absent corners read (0,0)
        p2 = tmp_path / "mixed.obj"
        p2.write_text(
            "v 0 0 0\nv 1 0 0\nv 1 1 0\nvt 0.5 0.5\n"
            "f 1/1 2 3\n"
        )
        nat2 = _load_obj_native(p2)
        py2 = load_obj(p2, prefer_native=False)
        np.testing.assert_allclose(nat2.uvs, py2.uvs, rtol=1e-6)

    def test_native_index_forms(self, obj_file):
        from ntrace_tpu.native import native_available

        if not native_available():
            pytest.skip("no g++ toolchain")
        from ntrace_tpu.io.obj import _load_obj_native

        py = load_obj(obj_file, prefer_native=False)
        nat = _load_obj_native(obj_file)
        np.testing.assert_array_equal(nat.indices, py.indices)
        np.testing.assert_array_equal(nat.mat_ids, py.mat_ids)
        assert nat.materials[1].diffuse == (1.0, 0.0, 0.0)


class TestImageIO:
    def test_tonemap_and_png(self, tmp_path):
        img = np.linspace(0, 2, 48).reshape(4, 4, 3).astype(np.float32)
        u8 = tonemap(img)
        assert u8.dtype == np.uint8 and u8.max() == 255
        p = tmp_path / "i.png"
        write_png(p, img)
        from PIL import Image

        back = np.asarray(Image.open(p))
        np.testing.assert_array_equal(back, u8)

    def test_png_roundtrip_without_pil(self, tmp_path):
        """write_png needs only zlib + struct; read_png reads it back
        bit-exactly, odd sizes included."""
        rng = np.random.default_rng(4)
        img = rng.integers(0, 256, size=(7, 13, 3), dtype=np.uint8)
        p = tmp_path / "rt.png"
        write_png(str(p), img)
        np.testing.assert_array_equal(read_png(str(p)), img)
        f = rng.uniform(0, 2, size=(5, 6, 3)).astype(np.float32)
        write_png(str(p), f)
        np.testing.assert_array_equal(read_png(str(p)), tonemap(f))

    def test_checksum_stable(self):
        img = np.ones((8, 8, 3), np.float32) * 0.5
        assert checksum(img) == checksum(img.copy())
        assert checksum(img) != checksum(img * 0.9)


class TestImageFormats:
    """BMP/TGA/TIFF/PNG round trips (~ io/Image*IO codecs)."""

    def test_roundtrip_all_formats(self, tmp_path):
        from ntrace_tpu.io.image import FORMATS, read_image, write_image

        rng = np.random.default_rng(3)
        img8 = rng.integers(0, 256, (17, 23, 3)).astype(np.uint8)
        for ext in FORMATS:
            p = tmp_path / f"rt{ext}"
            write_image(str(p), img8)
            back = read_image(str(p))
            np.testing.assert_array_equal(back, img8, err_msg=ext)

    def test_float_input_tonemapped(self, tmp_path):
        from ntrace_tpu.io.image import read_image, tonemap, write_image

        img = np.random.default_rng(4).random((8, 8, 3)).astype(np.float32)
        p = tmp_path / "f.bmp"
        write_image(str(p), img)
        np.testing.assert_array_equal(read_image(str(p)), tonemap(img))

    def test_unknown_format_rejected(self, tmp_path):
        from ntrace_tpu.io.image import write_image

        with pytest.raises(ValueError):
            write_image(str(tmp_path / "x.jpg"),
                        np.zeros((4, 4, 3), np.uint8))


class TestNativeTextureFallback:
    def test_textured_obj_takes_python_parser(self, tmp_path, monkeypatch):
        """Native fast path must NOT silently drop vt records: a textured
        MTL forces the Python parser so Scene.uvs survives."""
        from ntrace_tpu.io import obj as objmod

        tex = tmp_path / "t.png"
        from ntrace_tpu.io.image import write_image
        write_image(str(tex), np.zeros((2, 2, 3), np.uint8))
        (tmp_path / "m.mtl").write_text(
            "newmtl painted\nKd 1 0 0\nmap_Kd t.png\n")
        lines = ["mtllib m.mtl", "usemtl painted"]
        for v in [(0, 0, 0), (1, 0, 0), (0, 1, 0)]:
            lines.append(f"v {v[0]} {v[1]} {v[2]}")
        lines += ["vt 0 0", "vt 1 0", "vt 0 1", "f 1/1 2/2 3/3"]
        p = tmp_path / "tex.obj"
        p.write_text("\n".join(lines) + "\n")
        monkeypatch.setattr(objmod, "NATIVE_THRESHOLD_BYTES", 0)
        scene = load_obj(p, prefer_native=True)
        assert scene.uvs is not None and scene.uvs.shape == (1, 3, 2)
        assert scene.materials[scene.mat_ids[0]].texture.endswith("t.png")


class TestOOMRetry:
    def test_trace_batched_halves_cap_on_resource_exhausted(self):
        """SURVEY SS6.3: the harness retries device OOM with halved caps."""
        import jax.numpy as jnp

        from ntrace_tpu.ray.raybatch import RayBatch
        from ntrace_tpu.render.renderer import _trace_batched

        n = 64 * 1024
        batch = RayBatch(
            orig=jnp.zeros((n, 3)), dirn=jnp.ones((n, 3)),
            tmin=jnp.zeros((n,)), tmax=jnp.ones((n,)),
            slot_to_id=jnp.arange(n),
        )
        calls = []

        def tracer(o, d, tn, tx, any_hit):
            calls.append(o.shape[0])
            if o.shape[0] > 16 * 1024:
                raise RuntimeError("RESOURCE_EXHAUSTED: fake OOM")
            r = o.shape[0]
            return (jnp.full((r,), -1, jnp.int32), jnp.zeros((r,)),
                    jnp.zeros((r,)), jnp.zeros((r,)))

        out = _trace_batched(tracer, batch, cap=n, any_hit=False)
        assert out[0].shape[0] == n
        assert max(calls[-4:]) <= 16 * 1024  # retried at a reduced cap
        assert any(c > 16 * 1024 for c in calls)  # the OOM actually fired

    def test_non_oom_errors_propagate(self):
        import jax.numpy as jnp

        from ntrace_tpu.ray.raybatch import RayBatch
        from ntrace_tpu.render.renderer import _trace_batched

        batch = RayBatch(
            orig=jnp.zeros((8, 3)), dirn=jnp.ones((8, 3)),
            tmin=jnp.zeros((8,)), tmax=jnp.ones((8,)),
            slot_to_id=jnp.arange(8),
        )

        def tracer(o, d, tn, tx, any_hit):
            raise RuntimeError("some other failure")

        with pytest.raises(RuntimeError, match="other failure"):
            _trace_batched(tracer, batch, cap=8, any_hit=False)
