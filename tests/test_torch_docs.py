"""The port's own documents, on the CPU.

- tools/gen_api_docs_torch.py runs in a child process that loads no jax,
  jaxlib or safeincave_tpu module, and its pages equal the committed
  docs/api_torch/ file for file;
- every public module of safeincave_torch has a page, every page names its
  JAX counterpart or says that it is the port's own, and every counterpart
  link resolves to a page of docs/api/;
- docs/MIGRATION_TORCH.md's table has a row for every name that
  safeincave_tpu/__init__.py and its subpackages export, each naming a
  port object that exists, and every Python block of the page runs with
  ``device="cpu"``;
- every ``file:line`` of docs/ARCHITECTURE_TORCH.md points at the code
  that the page names beside it;
- importing safeincave_torch and the generator loads no JAX module, and
  the two packages carry the same ``__version__``.
"""
import filecmp
import importlib
import json
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg

torch.set_num_threads(1)

ROOT = cfg.ROOT
GEN = os.path.join(ROOT, "tools", "gen_api_docs_torch.py")
API = os.path.join(ROOT, "docs", "api")
API_TORCH = os.path.join(ROOT, "docs", "api_torch")
ARCH = os.path.join(ROOT, "docs", "ARCHITECTURE_TORCH.md")
JAX_ROOTS = {"jax", "jaxlib", "safeincave_tpu"}
# the JAX package's modules whose __init__ exports the migration table maps
JAX_INITS = ("", ".app", ".bcs", ".fem", ".materials", ".mesh", ".output",
             ".parallel")


def child_roots(code):
    """Run ``code`` in a fresh interpreter at the repository root; returns
    the top-level names of the modules it loaded."""
    tail = ("\nimport json, sys\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code + tail], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return set(json.loads(out.stdout.splitlines()[-1]))


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """The generator's pages of a fresh run, and the modules it loaded."""
    out = str(tmp_path_factory.mktemp("api_torch"))
    roots = child_roots(f"import runpy, sys\nsys.argv = [{GEN!r}, '--out', "
                        f"{out!r}]\nrunpy.run_path({GEN!r}, "
                        f"run_name='__main__')")
    return out, roots


def test_generator_loads_no_jax(generated):
    _, roots = generated
    assert "safeincave_torch" in roots and "torch" in roots
    assert not roots & JAX_ROOTS, sorted(roots & JAX_ROOTS)


def test_generated_pages_equal_the_committed(generated):
    out, _ = generated
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(API_TORCH))
    match, mismatch, errors = filecmp.cmpfiles(out, API_TORCH, names,
                                               shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def public_modules():
    names = ["safeincave_torch"]
    for m in pkgutil.walk_packages(st.__path__, prefix="safeincave_torch."):
        if not any(p.startswith("_") for p in m.name.split(".")):
            names.append(m.name)
    return names


def test_every_public_module_has_a_page():
    pages = set(os.listdir(API_TORCH))
    missing = [m for m in public_modules()
               if m.replace(".", "_") + ".md" not in pages]
    assert not missing, missing
    for extra in ("safeincave_torch__build.md", "safeincave_torch__device.md",
                  "safeincave_torch_csrc.md", "index.md"):
        assert extra in pages, extra


def test_counterpart_links_resolve():
    links = 0
    for name in sorted(os.listdir(API_TORCH)):
        with open(os.path.join(API_TORCH, name)) as f:
            text = f.read()
        if name != "index.md":
            head = text.split("\n")[2]
            assert head.startswith(("JAX counterpart: ", "Port only: ")), \
                (name, head)
        for target in re.findall(r"\]\(\.\./api/([^)]+)\)", text):
            assert os.path.isfile(os.path.join(API, target)), (name, target)
            links += 1
    assert links > 40


def jax_exports():
    for sub in JAX_INITS:
        mod = importlib.import_module("safeincave_tpu" + sub)
        for name in mod.__all__:
            yield sub, name


def test_migration_table_covers_every_jax_export():
    with open(cfg.MIGRATION) as f:
        rows = {m.group(1): m.group(2) for m in re.finditer(
            r"^\| `(safeincave_tpu[\w.]*)` \| `(safeincave_torch[\w.]*)` \|",
            f.read(), re.M)}
    exports = [("", "__version__")] + list(jax_exports())
    assert len(exports) > 90
    for sub, name in exports:
        key = f"safeincave_tpu{sub}.{name}"
        assert key in rows, key
        port_mod, _, attr = rows[key].rpartition(".")
        assert hasattr(importlib.import_module(port_mod), attr), rows[key]


def test_migration_blocks_run_on_the_cpu(tmp_path):
    assert len(cfg.migration_blocks()) >= 5
    ns = cfg.run_migration_blocks("cpu", str(tmp_path))
    assert ns["eq"].u.device.type == "cpu"
    assert os.path.isfile(tmp_path / "output" / "box" / "u" / "u.h5")


REF = re.compile(r"((?:safeincave_torch|safeincave_tpu|tests|tools|docs)/"
                 r"[\w/.]+\.(?:py|cu|md))?:(\d+)(?:-(\d+))?")
# a line of code, which a header comment cited from line 1 must not reach
CODE = re.compile(r"(import |from \S+ import|def |class |#include)")


def architecture_refs(text):
    """Each ``file:line`` or ``file:first-last`` of the page (a bare
    ``:line`` continues the last file named in its paragraph) with the
    names the page gives beside it: the words of the backticked spans
    between it and its neighbouring references, and those of the last
    reference before it in the paragraph that had any."""
    for para in text.split("\n\n"):
        spans = re.findall(r"`([^`]+)`", para)
        refs = [REF.fullmatch(s) for s in spans]
        path, last = None, []
        for i, m in enumerate(refs):
            if not m:
                continue
            path = m.group(1) or path
            lo, hi = i, i + 1
            while lo and not refs[lo - 1]:
                lo -= 1
            while hi < len(spans) and not refs[hi]:
                hi += 1
            own = [w for s in spans[lo:i] + spans[i + 1:hi]
                   for w in re.findall(r"[A-Za-z_]\w{2,}", s)]
            yield path, int(m.group(2)), int(m.group(3) or m.group(2)), \
                own + last
            last = own or last


def test_architecture_references_resolve():
    """Every ``file:line`` of the architecture page points at the code the
    page names beside it: one of those names stands on the cited lines or
    one line around them.  A range from line 1 cites the file's header
    comment, which must still span it."""
    with open(ARCH) as f:
        refs = list(architecture_refs(f.read()))
    assert len(refs) > 20
    for path, first, last, names in refs:
        assert path, (first, last)
        with open(os.path.join(ROOT, path)) as f:
            lines = f.read().splitlines()
        assert last <= len(lines), (path, first, last)
        if first == 1:
            assert not any(CODE.match(ln) for ln in lines[:last]), (path,
                                                                   last)
        else:
            window = "\n".join(lines[first - 2:last + 1])
            assert any(w in window for w in names), (path, first, last,
                                                      names)


def test_port_and_generator_load_no_jax():
    roots = child_roots("import sys, importlib.util\n"
                        "sys.path.insert(0, 'tools')\n"
                        "import safeincave_torch\n"
                        "import gen_api_docs_torch\n")
    assert {"safeincave_torch", "gen_api_docs_torch"} <= roots
    assert not roots & JAX_ROOTS, sorted(roots & JAX_ROOTS)
    assert st.__version__ == sc.__version__
