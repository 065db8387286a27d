"""The torch port's native PNG loader (g++ and libpng): its build under
build/ygz_tpu_torch/, its decodes against io/png.py and the JAX package's
loader, and the prefetcher's order."""
import numpy as np
import pytest
from PIL import Image

from ygz_tpu import native as jnative
from ygz_tpu_torch import native
from ygz_tpu_torch.io import png


@pytest.fixture
def pngs(tmp_path):
    """Gray frames written by PIL (its adaptive row filters) and by the
    port's encoder, and an RGB one."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:48, :64]
    paths = []
    for i in range(6):
        arr = np.clip(110 + 70 * np.sin(xx / (3.0 + i)) + 30 * np.cos(yy / 5.0)
                      + rng.normal(0, 5, (48, 64)), 0, 255).astype(np.uint8)
        p = str(tmp_path / f"img{i}.png")
        if i % 2:
            png.write_png(p, arr)
        else:
            Image.fromarray(arr).save(p)
        paths.append(p)
    p = str(tmp_path / "rgb.png")
    Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)).save(p)
    return paths + [p]


def test_native_builds_under_build_dir_and_decodes(pngs):
    assert native.available(), native.route()
    assert native.route() == "native (libpng)"
    lib = native.library_path()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "ygz_tpu_torch")
    for p in pngs:
        got = native.decode_gray(p)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, png.decode_gray(p))
        np.testing.assert_array_equal(got, jnative.decode_gray(p))


@pytest.mark.parametrize("threads,ahead", [(1, 1), (2, 3), (4, 8)])
def test_prefetcher_order_sequential_and_random(pngs, threads, ahead):
    """Every frame in order, then a random rising subset (the JAX
    prefetcher's contract: a frame behind the last one served waits
    forever, C-ref14)."""
    pf = native.FramePrefetcher(pngs, ahead=ahead, threads=threads)
    assert pf._native is not None
    for i in range(len(pngs)):
        np.testing.assert_array_equal(pf.get(i), png.decode_gray(pngs[i]))
    rng = np.random.default_rng(threads)
    pick = np.sort(rng.choice(len(pngs), 4, replace=False))
    pf = native.FramePrefetcher(pngs, ahead=ahead, threads=threads)
    for i in pick:
        np.testing.assert_array_equal(pf.get(int(i)),
                                      png.decode_gray(pngs[i]))
    with pytest.raises(IndexError):
        pf.get(len(pngs))


def test_a_cached_library_that_does_not_load_is_rebuilt(pngs, tmp_path,
                                                        monkeypatch):
    """A cached library that fails to load (one built on another machine)
    is rebuilt once, for the loader and the unfilter."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.BUILD_DIR.mkdir()
    for path in (native.library_path(), native.unfilter_library_path()):
        path.write_bytes(b"not a shared library")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_mod", None)
    monkeypatch.setattr(native, "_unfilter", None)
    assert native.available(), native.route()
    assert native.unfilter_fn()[0] is not None
    for path in (native.library_path(), native.unfilter_library_path()):
        assert path.read_bytes()[:4] == b"\x7fELF"
    for p in pngs:
        np.testing.assert_array_equal(native.decode_gray(p),
                                      png.decode_gray(p, force_python=True))


def test_fallback_route_decodes_the_same(pngs, monkeypatch):
    """Without the native build, io/png.py decodes, the prefetcher reads
    synchronously and route() says why."""
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "_mod", None)
    monkeypatch.setattr(native, "_why", "RuntimeError: no libpng")
    assert not native.available()
    assert native.route() == ("io/png.py with the C unfilter "
                              "(RuntimeError: no libpng)")
    pf = native.FramePrefetcher(pngs)
    assert pf._native is None
    for i, p in enumerate(pngs):
        np.testing.assert_array_equal(native.decode_gray(p),
                                      jnative.decode_gray(p))
        np.testing.assert_array_equal(pf.get(i), jnative.decode_gray(p))


def test_native_refuses_what_io_png_refuses(tmp_path):
    p = str(tmp_path / "p.png")
    Image.fromarray(np.zeros((8, 8), np.uint8)).convert("P").save(p)
    with pytest.raises(OSError, match="palette"):
        native.decode_gray(p)
    with pytest.raises(ValueError, match="palette"):
        png.decode_gray(p)
