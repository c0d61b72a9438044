"""The port's native mesh kernels (``heatflow_tpu_torch.native``, its own
copy of ``meshkernel.cpp`` built with g++ into ``build/heatflow_tpu_torch``)
against the port's numpy paths and the JAX package's native binding, at the
tolerances of ``tests/test_native.py``; ``assemble_stencils``'s backends,
and a failed build that raises."""

import os

import numpy as np
import pytest

from heatflow_tpu import native as jnative
from heatflow_tpu.geometry import build_layout as j_layout
from heatflow_tpu.mesh.structured import build_structured_mesh as j_mesh
from heatflow_tpu_torch import native
from heatflow_tpu_torch.geometry import build_layout
from heatflow_tpu_torch.mesh.axes import graded_axis
from heatflow_tpu_torch.mesh.structured import build_structured_mesh
from heatflow_tpu_torch.ops import _build
from heatflow_tpu_torch.ops.stencil import assemble_stencils
from tests.fixtures import tiny_no_diamond_cfg

PLANES = ("K", "M", "K_flat", "M_flat", "G_r", "G_z", "M_proj")
TOL = 1e-13      # of each plane's max abs (tests/test_native.py)


def mesh_of(coarse):
    return build_structured_mesh(*build_layout(tiny_no_diamond_cfg(
        coarse=coarse)))


@pytest.fixture
def fresh_lib(monkeypatch):
    """The binding with no library loaded yet (restored afterwards)."""
    monkeypatch.setattr(native, "_lib", None)


def planes_close(got, want, tol=TOL):
    for name in PLANES:
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), name


def test_graded_axis_matches_numpy_and_jax():
    spans = [(0.0, 2.0, 0.5), (1.0, 10.0, 2.0), (4.0, 5.0, 0.25)]
    got = native.native_graded_axis(0.0, 10.0, spans, 2.0)
    np.testing.assert_allclose(got, graded_axis(0.0, 10.0, spans), rtol=0,
                               atol=1e-12)
    if jnative.get_lib() is not None:
        np.testing.assert_allclose(
            got, jnative.native_graded_axis(0.0, 10.0, spans, 2.0), rtol=0,
            atol=1e-12)


def test_graded_axis_grows_its_buffer():
    """More coordinates than the first capacity guess: the second call's
    buffer holds them."""
    spans = [(0.0, 1.0, 1e-3)]
    got = native.native_graded_axis(0.0, 1.0, spans, 1.0)
    np.testing.assert_allclose(got, graded_axis(0.0, 1.0, spans, 1.0),
                               rtol=0, atol=1e-12)
    assert len(got) == 1001


def test_cell_tags_match_numpy_and_jax():
    cfg = tiny_no_diamond_cfg()
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    rects = np.array([m.bounds for m in mats])
    got = native.native_assign_cell_tags(mesh.z, mesh.r, rects)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, mesh.cell_tags)
    mj = j_mesh(*j_layout(cfg))
    np.testing.assert_array_equal(got, mj.cell_tags)


@pytest.mark.parametrize("coarse", [1.0, 2.0, 3.0])
def test_assembly_matches_numpy_and_jax(coarse):
    mesh = mesh_of(coarse)
    nat = assemble_stencils(mesh, backend="native")
    planes_close(nat, assemble_stencils(mesh, backend="numpy"))
    jm = j_mesh(*j_layout(tiny_no_diamond_cfg(coarse=coarse)))
    planes_close(nat, jnative_pack(jm))


def jnative_pack(jm):
    from heatflow_tpu.ops.stencil import assemble_stencils as j_assemble
    return j_assemble(jm, backend="auto" if jnative.get_lib() is not None
                      else "numpy")


def test_auto_is_native_where_a_compiler_is(monkeypatch):
    monkeypatch.delenv("HEATFLOW_TPU_NO_NATIVE", raising=False)
    if _build.find_cxx() is None:
        pytest.skip("no C++ compiler on PATH: 'auto' is numpy here")
    mesh = mesh_of(3.0)
    auto = assemble_stencils(mesh, backend="auto")
    nat = assemble_stencils(mesh, backend="native")
    for name in PLANES:
        np.testing.assert_array_equal(getattr(auto, name),
                                      getattr(nat, name))
    planes_close(auto, assemble_stencils(mesh, backend="numpy"))


def test_auto_is_numpy_without_compiler_or_when_switched_off(monkeypatch):
    mesh = mesh_of(3.0)
    ref = assemble_stencils(mesh, backend="numpy")
    monkeypatch.setenv("HEATFLOW_TPU_NO_NATIVE", "1")
    assert not native.available()
    got = assemble_stencils(mesh, backend="auto")
    monkeypatch.delenv("HEATFLOW_TPU_NO_NATIVE")
    monkeypatch.setattr(_build, "find_cxx", lambda: None)
    assert not native.available()
    got2 = assemble_stencils(mesh, backend="auto")
    for name in PLANES:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
        np.testing.assert_array_equal(getattr(got2, name),
                                      getattr(ref, name))


def test_failed_build_raises(tmp_path, monkeypatch, fresh_lib):
    """A source that does not compile: 'native' raises with the compiler's
    message, and so does 'auto' (no quiet fall back to numpy)."""
    if _build.find_cxx() is None:
        pytest.skip("no C++ compiler on PATH")
    bad = tmp_path / "meshkernel.cpp"
    bad.write_text("extern \"C\" { this is not C++ }\n")
    monkeypatch.setattr(_build, "MESH_SRC", str(bad))
    monkeypatch.delenv("HEATFLOW_TPU_NO_NATIVE", raising=False)
    mesh = mesh_of(3.0)
    for backend in ("native", "auto"):
        with pytest.raises(RuntimeError, match="failed"):
            assemble_stencils(mesh, backend=backend)
    assert not os.path.exists(_build.native_library_path())


def test_native_without_compiler_raises(monkeypatch, fresh_lib, tmp_path):
    monkeypatch.setattr(_build, "find_cxx", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        assemble_stencils(mesh_of(3.0), backend="native")


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        assemble_stencils(mesh_of(3.0), backend="gpu")


def test_library_is_the_ports_own(fresh_lib):
    """Built under build/heatflow_tpu_torch with the source's hash in its
    name; never the JAX package's library or directory."""
    if _build.find_cxx() is None:
        pytest.skip("no C++ compiler on PATH")
    lib = native.get_lib()
    path = _build.native_library_path()
    assert lib._name == path and os.path.exists(path)
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libhf_mesh_")
    assert "heatflow_tpu" + os.sep + "native" not in path
    with open(_build.MESH_SRC) as f:
        assert "hf_assemble_stencils" in f.read()


def test_assembly_rejects_mismatched_tags():
    mesh = mesh_of(3.0)
    with pytest.raises(ValueError, match="cell_tags"):
        native.native_assemble_stencils(mesh.z, mesh.r,
                                        mesh.cell_tags[:-1], 5)
