"""The native image decoder's build reports why it failed: the compiler's
exit code and the tail of its error output, or the missing tool, and
callers fall back to PIL (``get_loader`` gives None).  Each test builds
into its own directory with the module's state reset, so the package's
own build is left alone."""
import pytest

from samnerf_tpu_torch import native


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", None)
    return tmp_path


def test_compiler_error_is_reported(fresh, monkeypatch):
    if native.shutil.which(native.COMPILER) is None:
        pytest.skip(f"no {native.COMPILER} here to fail")
    broken = fresh / "loader.cpp"
    broken.write_text("int decode_images( { this_is_not_cpp; }\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    assert native.get_loader() is None
    reason = native.build_error()
    assert reason.startswith(f"{native.COMPILER} exited ")
    assert "loader.cpp" in reason and "error" in reason
    assert len(reason) <= native.ERROR_TAIL_CHARS + 40
    assert not list((fresh / "build").glob("*.tmp"))          # no half-built file left
    assert native.decode_images([fresh / "x.png"], 4, 4) is None


def test_missing_compiler_is_reported(fresh, monkeypatch):
    monkeypatch.setattr(native, "COMPILER", "no-such-compiler-for-this-test")
    assert native.get_loader() is None
    assert native.build_error() == "no no-such-compiler-for-this-test on PATH"


def test_a_build_that_loads_reports_nothing(fresh):
    assert native.build_error() is None                    # nothing tried yet
    if native.get_loader() is None:
        pytest.skip(f"the decoder does not build here: {native.build_error()}")
    assert native.build_error() is None
    assert len(list((fresh / "build").glob("libloader_*.so"))) == 1
