"""Generate the markdown API reference of gisnav_tpu_torch (stdlib only).

The port's counterpart of ``tools/gen_api_docs.py``: walks
``gisnav_tpu_torch``, imports every module (importing builds nothing: the
kernels and the host C++ libraries are built at their first use) and writes
one page per subpackage into ``docs/api_torch/``. Each module's section
opens with one line naming its ``gisnav_tpu`` counterpart: the module of
the same path where there is one, else the first ``gisnav_tpu/...`` file its
docstring names, else none. ``kernels.md`` also lists the hand-written
CUDA sources under ``gisnav_tpu_torch/kernels/``, each with the module that
loads it and the TPU kernel it replaces (from the source's header). Needs
no JAX and no card.

Usage::

    python tools/gen_api_docs_torch.py [--out docs/api_torch]
"""
from __future__ import annotations

import argparse
import importlib
import os
import pkgutil
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from gen_api_docs import (  # noqa: E402
    _clean_doc,
    _public_members,
    _render_class,
    _render_function,
)

PORT = "gisnav_tpu_torch"
SKIP_MODULES = {f"{PORT}.__main__"}
KERNELS = os.path.join(ROOT, PORT, "kernels")


def counterpart(modname: str, doc: str) -> str:
    """The ``gisnav_tpu`` file a port module stands for."""
    rel = modname.split(".")[1:]
    for path in (os.path.join("gisnav_tpu", *rel) + ".py",
                 os.path.join("gisnav_tpu", *rel, "__init__.py")):
        if os.path.exists(os.path.join(ROOT, path)):
            return f"`{path}`"
    named = re.search(r"``(gisnav_tpu/[\w/]+\.py)``", doc.replace("\n", " "))
    return f"`{named.group(1)}` (named in its docstring)" if named else \
        "none: the port's own module"


def render_module(modname: str) -> str:
    import inspect

    mod = importlib.import_module(modname)
    doc = _clean_doc(mod)
    lines = [f"## `{modname}`", "",
             f"*Counterpart:* {counterpart(modname, doc)}", ""]
    if doc:
        lines += [doc, ""]
    for name, obj in _public_members(mod):
        lines.append(_render_class(name, obj) if inspect.isclass(obj)
                     else _render_function(name, obj))
    return "\n".join(lines)


def kernel_sources() -> str:
    """A section on the CUDA sources: what each computes and replaces, and
    the module whose wrappers load it."""
    loaders = {}
    for dirpath, _, files in os.walk(os.path.join(ROOT, PORT)):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    for lib in re.findall(r'library\("(\w+)"\)', f.read()):
                        loaders[lib] = os.path.relpath(path, ROOT)
    lines = ["## CUDA sources (`gisnav_tpu_torch/kernels/`)", "",
             "Built with nvcc for `sm_90a` at their first use "
             "(`kernels/build.py`); on a CPU tensor each wrapper runs its "
             "kernel's plain PyTorch version.", ""]
    for name in sorted(os.listdir(KERNELS)):
        if not name.endswith((".cu", ".cuh")):
            continue
        with open(os.path.join(KERNELS, name)) as f:
            header = []
            for line in f:
                if not line.startswith("//"):
                    break
                header.append(line[2:].strip())
        text = " ".join(header)
        first = re.match(r"(.*?\.)(?: |$)", text)
        title = first.group(1) if first else name
        replaces = re.search(r"(Replaces the TPU kernels? .*?\.)(?: |$)",
                             text)
        stem = os.path.splitext(name)[0]
        lines.append(f"- `{name}`: {title}"
                     + (f" {replaces.group(1)}" if replaces else "")
                     + (f" Loaded by `{loaders[stem]}`." if stem in loaders
                        else " A header the kernels include."))
    return "\n".join(lines) + "\n"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "docs", "api_torch"))
    args = ap.parse_args()

    port = importlib.import_module(PORT)
    groups: dict[str, list[str]] = {"core": [PORT]}
    for info in pkgutil.walk_packages(port.__path__, prefix=f"{PORT}."):
        if info.name in SKIP_MODULES:
            continue
        parts = info.name.split(".")
        group = parts[1] if len(parts) > 2 or info.ispkg else "core"
        groups.setdefault(group, [])
        if info.ispkg:
            # a subpackage's __init__ holds its exports and docstring
            groups[group].insert(0, info.name)
        else:
            groups[group].append(info.name)

    os.makedirs(args.out, exist_ok=True)
    index = [f"# {PORT} API reference", "",
             "Generated by `tools/gen_api_docs_torch.py` from the port's "
             "module docstrings; each module names its `gisnav_tpu` "
             "counterpart (`docs/api/`).", ""]
    for group in sorted(groups):
        pages = [render_module(m) for m in groups[group]]
        if group == "kernels":
            pages.append(kernel_sources())
        with open(os.path.join(args.out, f"{group}.md"), "w") as f:
            f.write(f"# `{PORT}.{group}`\n\n" if group != "core"
                    else f"# `{PORT}` (top level)\n\n")
            f.write("\n\n".join(pages))
        index.append(f"- [`{group}`]({group}.md): " + ", ".join(
            "`__init__`" if m in (PORT, f"{PORT}.{group}")
            else m.split(".")[-1] for m in groups[group]))
    with open(os.path.join(args.out, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print(f"wrote {len(groups) + 1} pages to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
