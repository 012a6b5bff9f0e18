"""The port as an installed package, on the CPU.

A wheel is built offline (``pip wheel --no-deps --no-build-isolation``,
the setuptools already installed) from a copy of the files the build needs,
so the checkout gets no ``build/`` or ``*.egg-info``.  It must hold every
module, kernel source and CLI twin of voicecraft_tpu_torch, and every
console script of the JAX package must have a ``-torch`` twin.  The wheel
is installed with ``pip install --no-deps --target`` and run in
subprocesses whose working directory and ``sys.path`` exclude the
checkout: every module imports, ``voicecraft_tpu_torch.__file__`` and the
build roots lie in the target, every torch CLI answers ``--help``, the
native code reader builds there with g++ and reads a code file as the
checkout's does, and the installed ``voicecraft-tts-torch`` writes the
same wavs, byte for byte, as the checkout's ``tts_torch_cli.py`` (tiny_test,
random weights, the same seed).  In the checkout, the build roots lie
under a ``build/`` that ``.gitignore`` lists, and a build root that cannot
be written raises with its path."""

import configparser
import json
import os
import re
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "voicecraft_tpu_torch"
# dotted names of every module of the port on disk
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py") if "build" not in p.relative_to(PORT).parts)
TORCH_CLIS = sorted(p.stem for p in REPO.glob("*_torch_cli.py")) + ["bench_torch"]
SOURCES = sorted(str(p.relative_to(REPO)) for p in
                 [*PORT.glob("csrc/*.cu"), *PORT.glob("csrc/*.cuh"),
                  PORT / "native" / "dataio.cpp"])
PIP = [sys.executable, "-m", "pip", "--disable-pip-version-check",
       "--no-input", "--no-cache-dir"]
TTS_ARGS = ["--model", "tiny_test", "--random-init", "--device", "cpu",
            "--text-backend", "grapheme", "--top-k", "15",
            "--silence-tokens", "5", "7", "--seed", "3",
            "--prompt-wav", str(REPO / "demo" / "demo.wav"),
            "--prompt-transcript", "the sound of birds over the river at dawn",
            "--target-transcript", "the river runs past the mill"]
CODES = "1 2 3 4 5\n6 7 8 9 10\n11 12 13 14 15\n16 17 18 19 20\n"

# run inside the installed copy: what it imports and where it builds
PROBE = r"""
import contextlib, importlib, io, json, runpy, sys
modules, clis, mains, codes = sys.argv[1:]
out = {"sys_path": list(sys.path), "imports": {}, "help": {}, "mains": {}}
for name in json.loads(modules):
    try:
        importlib.import_module(name)
        out["imports"][name] = None
    except Exception as e:
        out["imports"][name] = f"{type(e).__name__}: {e}"
for cli in json.loads(clis):
    buf = io.StringIO()
    sys.argv = [cli, "--help"]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_module(cli, run_name="__main__")
        code = None
    except SystemExit as e:
        code = e.code
    except Exception as e:
        code = f"{type(e).__name__}: {e}"
    out["help"][cli] = [code, buf.getvalue()]
for mod, fn in json.loads(mains):
    out["mains"][f"{mod}:{fn}"] = callable(
        getattr(importlib.import_module(mod), fn, None))
try:
    import voicecraft_tpu_torch
    from voicecraft_tpu_torch import native
    from voicecraft_tpu_torch.ops import _native
    out["file"] = voicecraft_tpu_torch.__file__
    out["kernel_root"] = str(_native.BUILD_ROOT)
    out["csrc"] = str(_native.CSRC_DIR)
    out["native_root"] = str(native.BUILD_ROOT)
    out["native_built"] = native.get_lib() is not None
    out["native_lib"] = str(native.lib_path())
    out["codes"] = native.load_codes(codes, 4).tolist()
except Exception as e:
    out["error"] = f"{type(e).__name__}: {e}"
out["jax"] = "jax" in sys.modules
print("PROBE " + json.dumps(out))
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return dict(env, OMP_NUM_THREADS="1", **extra)


def _run(cmd, cwd, env=None, timeout=300):
    res = subprocess.run(cmd, cwd=cwd, env=env or _env(), capture_output=True,
                         text=True, timeout=timeout)
    assert res.returncode == 0, f"{cmd[:4]}\n{res.stderr[-4000:]}"
    return res


def _probed(installed):
    """(target, the probe's report, its working directory), once the probe
    got past the imports."""
    assert "error" not in installed[1], installed[1]["error"]
    return installed


def _inside(path, root) -> bool:
    return Path(path).resolve().is_relative_to(Path(root).resolve())


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """A wheel built from a copy of the checkout's build inputs."""
    src = tmp_path_factory.mktemp("src")
    for name in ("pyproject.toml", "README.md", *(p.name for p in
                                                  REPO.glob("*.py"))):
        shutil.copy2(REPO / name, src / name)
    skip = shutil.ignore_patterns("__pycache__", "build", "*.so",
                                  "*.egg-info")
    for pkg in ("voicecraft_tpu", "voicecraft_tpu_torch"):
        shutil.copytree(REPO / pkg, src / pkg, ignore=skip)
    dist = tmp_path_factory.mktemp("dist")
    _run([*PIP, "wheel", str(src), "--no-deps", "--no-build-isolation",
          "--no-index", "-w", str(dist)], cwd=src)
    (whl,) = dist.glob("*.whl")
    return whl


@pytest.fixture(scope="module")
def entry_points(wheel):
    with zipfile.ZipFile(wheel) as z:
        (name,) = [n for n in z.namelist()
                   if n.endswith(".dist-info/entry_points.txt")]
        text = z.read(name).decode()
    cp = configparser.ConfigParser()
    cp.read_string(text)
    return dict(cp["console_scripts"])


@pytest.fixture(scope="module")
def installed(wheel, entry_points, tmp_path_factory):
    """(target, the probe's report, its working directory): the wheel
    installed with --no-deps --target, probed from outside the checkout."""
    target = tmp_path_factory.mktemp("target")
    work = tmp_path_factory.mktemp("work")
    _run([*PIP, "install", "--no-deps", "--no-index", "--target",
          str(target), str(wheel)], cwd=work)
    codes = work / "codes.txt"
    codes.write_text(CODES)
    mains = [v.split(":") for k, v in entry_points.items()
             if k.endswith("-torch")]
    res = _run([sys.executable, "-c", PROBE, json.dumps(MODULES),
                json.dumps(TORCH_CLIS), json.dumps(mains), str(codes)],
               cwd=work, env=_env(PYTHONPATH=str(target)))
    (line,) = [ln for ln in res.stdout.splitlines() if ln.startswith("PROBE ")]
    return target, json.loads(line[len("PROBE "):]), work


def test_wheel_holds_every_module_source_and_cli(wheel):
    with zipfile.ZipFile(wheel) as z:
        names = set(z.namelist())
    want = {str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
            if "build" not in p.relative_to(PORT).parts}
    want |= set(SOURCES) | {f"{cli}.py" for cli in TORCH_CLIS}
    assert len(want) > len(MODULES) + 10
    assert sorted(want - names) == []


def test_each_jax_console_script_has_a_torch_twin(entry_points, installed):
    target, probe, _ = installed
    jax_scripts = [k for k in entry_points if not k.endswith("-torch")]
    assert len(jax_scripts) >= 4
    for name in jax_scripts:
        mod, fn = entry_points[name].split(":")
        twin = entry_points.get(f"{name}-torch")
        assert twin == f"{mod.removesuffix('_cli')}_torch_cli:{fn}", name
        assert probe["mains"][twin], twin
        assert (target / "bin" / f"{name}-torch").is_file()


@pytest.mark.parametrize("module", MODULES)
def test_installed_module_imports(installed, module):
    assert installed[1]["imports"][module] is None, installed[1]["imports"][module]


def test_installed_copy_is_the_one_imported(installed):
    target, probe, work = _probed(installed)
    assert _inside(probe["file"], target)
    assert not probe["jax"]
    assert not [p for p in probe["sys_path"] if _inside(p or work, REPO)]


@pytest.mark.parametrize("cli", TORCH_CLIS)
def test_installed_cli_answers_help(installed, cli):
    code, text = installed[1]["help"][cli]
    assert code == 0 and text.startswith("usage:"), (code, text[-2000:])


def test_installed_build_roots_lie_in_the_package(installed):
    target, probe, _ = _probed(installed)
    pkg = target / "voicecraft_tpu_torch"
    assert Path(probe["kernel_root"]) == pkg.resolve() / "build" / "kernels"
    assert Path(probe["native_root"]) == pkg.resolve() / "build" / "native"
    assert Path(probe["csrc"]) == pkg.resolve() / "csrc"
    # nothing was written beside the installed packages
    assert not (target / "build").exists()


def test_installed_native_reader_reads_like_the_checkout(installed):
    from voicecraft_tpu_torch import native
    target, probe, work = _probed(installed)
    assert probe["native_built"]
    lib = Path(probe["native_lib"])
    assert lib.is_file() and _inside(lib, target / "voicecraft_tpu_torch" /
                                     "build" / "native")
    want = native.load_codes(str(work / "codes.txt"), 4)
    assert want.shape == (4, 5)
    np.testing.assert_array_equal(np.asarray(probe["codes"], np.int32), want)


def test_installed_tts_console_script_matches_the_checkout(installed,
                                                           tmp_path):
    """voicecraft-tts-torch from the target and tts_torch_cli.py from the
    checkout, run side by side: exit status 0 and the same wavs, byte for
    byte."""
    target, _, _ = installed
    runs = {}
    for name, cmd, env in (
            ("installed", [str(target / "bin" / "voicecraft-tts-torch")],
             _env(PYTHONPATH=str(target))),
            ("checkout", [sys.executable, str(REPO / "tts_torch_cli.py")],
             _env())):
        cwd = tmp_path / name
        cwd.mkdir()
        runs[name] = cwd, subprocess.Popen(
            [*cmd, *TTS_ARGS, "--out", str(cwd / "out.wav")], cwd=cwd,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, (cwd, proc) in runs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{name}:\n{err[-4000:]}"
    for wav in ("out.wav", "out_gen_only.wav"):
        got = (tmp_path / "installed" / wav).read_bytes()
        want = (tmp_path / "checkout" / wav).read_bytes()
        assert len(want) > 44 + 16000 and got == want, wav


def test_checkout_build_roots_are_ignored():
    """In a checkout, the kernels and the code reader build under the
    package's build/, which the .gitignore pattern build/ (a build
    directory at any depth) lists."""
    from voicecraft_tpu_torch import native
    from voicecraft_tpu_torch.ops import _native
    assert _native.BUILD_ROOT == PORT / "build" / "kernels"
    assert native.BUILD_ROOT == PORT / "build" / "native"
    assert "build/" in (REPO / ".gitignore").read_text().split()
    libs = [_native.BUILD_ROOT / "0123456789abcdef" / "libvc_kernels.so",
            native.lib_path()]
    for lib in libs:
        assert "build" in lib.relative_to(REPO).parts[:-1]
    if shutil.which("git") and (REPO / ".git").exists():
        res = subprocess.run(["git", "check-ignore", *map(str, libs)],
                             cwd=REPO, capture_output=True, text=True)
        assert res.stdout.split() == [str(p) for p in libs], res.stderr


def test_unwritable_build_root_raises_with_its_path(tmp_path, monkeypatch):
    """A build root under a file cannot be made: the kernel build and the
    code reader raise naming it, and the reader does not fall back to its
    Python version."""
    from voicecraft_tpu_torch import native
    from voicecraft_tpu_torch.ops import _native
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    monkeypatch.setattr(_native, "BUILD_ROOT", blocker / "kernels")
    with pytest.raises(RuntimeError, match=re.escape(str(blocker / "kernels"))):
        _native.build()
    monkeypatch.setattr(native, "BUILD_ROOT", blocker / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    for _ in range(2):                         # no fallback the second time
        with pytest.raises(RuntimeError,
                           match=re.escape(str(blocker / "native"))):
            native.get_lib()
