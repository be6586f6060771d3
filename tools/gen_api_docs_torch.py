"""Generate the Markdown API reference of safeincave_torch, the PyTorch/CUDA
port, beside the JAX package's (tools/gen_api_docs.py, docs/api/).

One page per module of the port - every public class with its methods and
signatures, every public function, the first docstring paragraphs - and a
page for the CUDA sources under safeincave_torch/csrc/.  Each page names
its counterpart page in docs/api/, or says that the module is the port's
own.  The output is deterministic: object addresses and the checkout's path
are cut from the reprs of defaults, so a fresh run can be compared with the
committed pages.  It imports torch and the port, never jax.

Run from the repo root:  python tools/gen_api_docs_torch.py [--out DIR]
Writes DIR/<module>.md and DIR/index.md (default docs/api_torch/).
"""
import argparse
import importlib
import inspect
import os
import pkgutil
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import safeincave_torch  # noqa: E402

PKG = "safeincave_torch"
JAX_PKG = "safeincave_tpu"
OUT = os.path.join(ROOT, "docs", "api_torch")
JAX_API = os.path.join(ROOT, "docs", "api")
CSRC = os.path.join(ROOT, PKG, "csrc")
# the port's private modules that hold a policy a user meets
DOCUMENTED_PRIVATE = {f"{PKG}._build", f"{PKG}._device"}
# what the port's own modules and sources are for
PORT_ONLY = {
    f"{PKG}._build": "builds the CUDA kernels with nvcc at first use",
    f"{PKG}._device": "the device policy: the card by default, no CPU "
                      "fallback",
    f"{PKG}.interop": "fields and checkpoints across the two packages "
                      "through numpy",
    f"{PKG}.output.hdf5": "the HDF5 writer and reader that SaveFields uses "
                          "in place of h5py",
    f"{PKG}.fem.graphs": "captured CUDA graphs of the time step's pieces, "
                         "the counterpart of jax.jit",
    f"{PKG}.parallel.dist": "one rank per card over torch.distributed",
    f"{PKG}.tracing": "spans, gaps, device spans and run records of the "
                      "port's own work, on by default",
    f"{PKG}.csrc": "the hand-written CUDA kernels",
}
# what the JAX package has and the port leaves out
LEFT_OUT = [
    (f"{JAX_PKG}.jax_setup", "JAX's global settings before any tracing "
     "(float64 mode, matmul precision, the compilation cache); the port "
     "names every dtype where it makes a tensor and compiles nothing at "
     "import"),
    (f"{JAX_PKG}.fem.bandplan", "the Pallas kernel's slab schedule "
     "(`BandPlan`); the CUDA band kernel's host tile plan is "
     f"`{PKG}.fem.bandkernel.BandTilePlan`"),
]
ADDRESS = re.compile(r" at 0x[0-9a-fA-F]+")


def clean(text):
    """``text`` without object addresses or the checkout's path."""
    return ADDRESS.sub("", text).replace(ROOT, "<repo>")


def first_doc(obj, limit=None):
    doc = inspect.getdoc(obj) or ""
    if limit is None:
        return doc
    return "\n\n".join(doc.split("\n\n")[:limit])


def sig_of(obj):
    try:
        return clean(str(inspect.signature(obj)))
    except (ValueError, TypeError):
        return "(...)"


def is_public_member(name, obj, mod_name):
    return not name.startswith("_") and \
        getattr(obj, "__module__", None) == mod_name


def page_name(mod_name):
    return mod_name.replace(".", "_") + ".md"


def jax_module_exists(jax_name):
    base = os.path.join(ROOT, *jax_name.split("."))
    return os.path.isfile(base + ".py") or \
        os.path.isfile(os.path.join(base, "__init__.py"))


def counterpart(mod_name):
    """(the counterpart line of a page, its short form for the index)."""
    if mod_name in PORT_ONLY:
        return (f"Port only: `{JAX_PKG}` has no counterpart "
                f"({PORT_ONLY[mod_name]}).", "port only")
    jax_name = JAX_PKG + mod_name[len(PKG):]
    page = page_name(jax_name)
    if os.path.isfile(os.path.join(JAX_API, page)):
        link = f"[`{jax_name}`](../api/{page})"
        return f"JAX counterpart: {link}.", link
    if jax_module_exists(jax_name):
        return (f"JAX counterpart: `{jax_name}` (no page in docs/api/).",
                f"`{jax_name}`")
    raise RuntimeError(f"{mod_name}: no counterpart in {JAX_PKG} and not "
                       f"listed as the port's own")


def render_module(mod_name, documented):
    """A module's page; ``documented`` is every module that has one."""
    mod = importlib.import_module(mod_name)
    line, _ = counterpart(mod_name)
    lines = [f"# `{mod_name}`", "", line, ""]
    mdoc = first_doc(mod)
    if mdoc:
        lines += [clean(mdoc), ""]
    if hasattr(mod, "__path__"):
        subs = sorted(m.name for m in pkgutil.iter_modules(
            mod.__path__, prefix=mod_name + ".") if m.name in documented)
        if subs:
            lines += ["Modules: " + ", ".join(
                f"[`{s}`]({page_name(s)})" for s in subs) + ".", ""]

    classes = [(n, o) for n, o in inspect.getmembers(mod, inspect.isclass)
               if is_public_member(n, o, mod_name)]
    funcs = [(n, o) for n, o in inspect.getmembers(mod, inspect.isfunction)
             if is_public_member(n, o, mod_name)]
    for name, cls in classes:
        lines += [f"## class `{name}{sig_of(cls)}`", ""]
        cdoc = first_doc(cls)
        if cdoc:
            lines += [clean(cdoc), ""]
        for mname, meth in inspect.getmembers(cls, inspect.isfunction):
            if mname.startswith("_") and mname != "__init__":
                continue
            if meth.__qualname__.split(".")[0] != name:
                continue   # inherited: documented on the base
            lines += [f"### `{name}.{mname}{sig_of(meth)}`", ""]
            mdoc2 = first_doc(meth, limit=2)
            if mdoc2:
                lines += [clean(mdoc2), ""]
    if funcs:
        lines += ["## Functions", ""]
        for name, fn in funcs:
            lines += [f"### `{name}{sig_of(fn)}`", ""]
            fdoc = first_doc(fn, limit=2)
            if fdoc:
                lines += [clean(fdoc), ""]
    return "\n".join(lines) + "\n", len(classes), len(funcs)


def leading_comment(path):
    """The ``//`` comment block a source starts with, as text."""
    out = []
    with open(path) as f:
        for ln in f:
            if not ln.startswith("//"):
                break
            text = ln[2:].rstrip("\n")
            out.append(text[1:] if text.startswith(" ") else text)
    return "\n".join(out).strip()


def c_entry_points(path):
    """The ``extern "C"`` functions of a source, one signature each."""
    with open(path) as f:
        text = f.read()
    sigs = re.findall(r'^extern "C" ([^{;]*\))', text, re.M)
    return [" ".join(s.split()) for s in sigs]


def render_csrc():
    mod_name = f"{PKG}.csrc"
    line, _ = counterpart(mod_name)
    lines = [f"# `{PKG}/csrc` (CUDA sources)", "", line, "",
             "Each source has a plain C interface and no PyTorch headers: "
             f"`{PKG}._build` compiles it with nvcc for `sm_90a` into "
             f"`{PKG}/_build/` at first use and loads it with ctypes.", ""]
    names = sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))
    for fname in names:
        path = os.path.join(CSRC, fname)
        lines += [f"## `{PKG}/csrc/{fname}`", "", "```text",
                  leading_comment(path), "```", "", "Entry points:", ""]
        lines += [f"- `{s}`" for s in c_entry_points(path)] + [""]
    return "\n".join(lines) + "\n", len(names)


def module_names():
    """Every module of the port that gets a page: all but private ones,
    and the private ones of :data:`DOCUMENTED_PRIVATE`."""
    names = [PKG]
    for m in pkgutil.walk_packages(safeincave_torch.__path__,
                                   prefix=PKG + "."):
        private = any(p.startswith("_") for p in m.name.split("."))
        if not private or m.name in DOCUMENTED_PRIVATE:
            names.append(m.name)
    return sorted(names)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT, help="output directory "
                    "(default docs/api_torch/)")
    out = ap.parse_args(argv).out
    os.makedirs(out, exist_ok=True)
    index = [f"# {PKG} API reference", "",
             "The PyTorch/CUDA port's modules, each beside its counterpart "
             "in the JAX package's reference (docs/api/).  Generated by "
             "`tools/gen_api_docs_torch.py` (run it after API changes; "
             "tests/test_torch_docs.py holds these pages to a fresh run).",
             "", "| module | classes | functions | JAX counterpart |",
             "|---|---|---|---|"]
    documented = module_names()
    for mod_name in documented:
        text, n_cls, n_fn = render_module(mod_name, documented)
        with open(os.path.join(out, page_name(mod_name)), "w") as f:
            f.write(text)
        index.append(f"| [`{mod_name}`]({page_name(mod_name)}) | {n_cls} | "
                     f"{n_fn} | {counterpart(mod_name)[1]} |")
    text, n_src = render_csrc()
    with open(os.path.join(out, page_name(f"{PKG}.csrc")), "w") as f:
        f.write(text)
    index.append(f"| [`{PKG}/csrc`]({page_name(f'{PKG}.csrc')}) | "
                 f"{n_src} CUDA sources | | port only |")
    index += ["", "## Left out of the port", ""]
    index += [f"- `{name}`: {why}." for name, why in LEFT_OUT]
    with open(os.path.join(out, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print(f"wrote {len(documented) + 1} pages and index.md to {out}")


if __name__ == "__main__":
    main()
