"""Every public name of ``visfly_tpu`` has its counterpart in
``visfly_tpu_torch``: the check that the port is complete.

The test reads both packages' sources with ``ast`` and imports neither. For
each module of the JAX package it lists the public module-level functions
and classes, the public methods of its public classes and, in an
``__init__.py``, every name it exports (its ``__all__``, else the public
names it imports). Each must be bound under the same name at the top level
of the port's module of the same path (a definition, an assignment or an
import), a method in the port's class of that name or in one of its bases
within the port's own sources, or stand in one of the two tables below:
names the port gives another module or name, and names that only JAX needs.
"""
import ast
import os
from functools import lru_cache

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "visfly_tpu")
PORT_PKG = os.path.join(ROOT, "visfly_tpu_torch")

# "module::name" of the JAX package → the port's "module::name", or a tuple
# of them where one JAX function has several counterparts
RENAMED = {
    # the Pallas kernels' module: the CUDA kernels' wrappers and plain versions
    "render/pallas_trace.py::KernelScene": "render/trace_kernel.py::KernelScene",
    "render/pallas_trace.py::prepare_kernel_scene":
        "render/trace_kernel.py::prepare_kernel_scene",
    "render/pallas_trace.py::cull_compact": "render/trace_kernel.py::cull_rows",
    "render/pallas_trace.py::pallas_trace": "render/trace_kernel.py::trace_march",
    "render/pallas_trace.py::pallas_trace_c": ("render/trace_kernel.py::trace_march",
                                               "render/trace_kernel.py::trace_analytic"),
    "render/pallas_trace.py::pallas_trace_diff_c": "render/trace_kernel.py::trace_diff",
    "render/pallas_trace.py::pallas_trace_diff": "render/trace_kernel.py::trace_diff",
    # the triangle tracer: the brute force and the tiled kernels
    "render/tri_trace.py::tri_trace_xla": "render/tri_trace.py::tri_trace_brute",
    "render/tri_trace.py::tri_trace_pallas": "render/tri_trace.py::tri_trace_tiled",
    "render/__init__.py::tri_trace_xla": "render/__init__.py::tri_trace_brute",
    "render/__init__.py::tri_trace_pallas": "render/__init__.py::tri_trace_tiled",
    # a leaf cast to the template's dtype (and device)
    "utils/checkpoint.py::jnp_asarray_like": "utils/checkpoint.py::asarray_like",
    # a phase timer that waited for the card at every phase: a span on the
    # profiler's own trace, whose key_averages sum the spans by name
    "utils/profiling.py::StepTimer": "utils/profiling.py::span",
    "utils/profiling.py::StepTimer.phase": "utils/profiling.py::span",
    "utils/profiling.py::StepTimer.summary": "utils/profiling.py::device_trace",
    "utils/profiling.py::StepTimer.report": "utils/profiling.py::device_trace",
}

# "module::name" of the JAX package → why the port has no counterpart
JAX_ONLY = {
    "utils/common.py::setup_compile_cache":
        "JAX's persistent XLA compile cache; the port's kernels build once into "
        "build.py's content-hashed build/kernels/ directory",
    "policies/autoencoder.py::DepthAutoencoder.setup":
        "flax's constructor hook; the port's nn.Module builds its layers in __init__",
}


def _modules(pkg):
    out = []
    for d, dirs, files in os.walk(pkg):
        dirs[:] = sorted(x for x in dirs if not x.startswith(("_", ".")))
        out += [os.path.relpath(os.path.join(d, f), pkg) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(out)


@lru_cache(maxsize=None)
def _tree(pkg, rel):
    path = os.path.join(pkg, rel)
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return ast.parse(f.read(), filename=path)


def _bindings(tree):
    """Top-level name → its node: definitions, assignments, imports."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                for n in ast.walk(tgt):
                    if isinstance(n, ast.Name):
                        out[n.id] = node
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and isinstance(node.target,
                                                                             ast.Name):
            out[node.target.id] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                out[(a.asname or a.name).split(".")[0]] = node
        elif isinstance(node, (ast.If, ast.Try)):
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef, ast.ClassDef)):
                    out.setdefault(sub.name, sub)
    return out


def _exports(tree):
    """An ``__init__.py``'s exports: its ``__all__``, else the public names
    it imports."""
    for node in tree.body:
        if (isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__"
                                                 for t in node.targets)):
            return [ast.literal_eval(e) for e in node.value.elts]
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names if not (a.asname or a.name).startswith("_")]


def _resolve_import(rel, node):
    """The module file (relative to the package) an ``ImportFrom`` in module
    ``rel`` reads, or None outside the package."""
    if not isinstance(node, ast.ImportFrom) or node.level == 0:
        return None
    base = os.path.dirname(rel).split(os.sep) if os.path.dirname(rel) else []
    base = base[:len(base) - (node.level - 1)] if node.level > 1 else base
    parts = base + (node.module.split(".") if node.module else [])
    for cand in (os.path.join(*parts) + ".py" if parts else None,
                 os.path.join(*(parts + ["__init__.py"]))):
        if cand and _tree(PORT_PKG, cand) is not None:
            return cand
    return None


def _port_class(rel, name, depth=0):
    """(module, ClassDef) of the port's class ``name`` as module ``rel``
    binds it, following imports within the port."""
    tree = _tree(PORT_PKG, rel)
    if tree is None or depth > 8:
        return None
    node = _bindings(tree).get(name)
    if isinstance(node, ast.ClassDef):
        return rel, node
    if isinstance(node, ast.ImportFrom):
        src = _resolve_import(rel, node)
        orig = next(a.name for a in node.names if (a.asname or a.name) == name)
        return None if src is None else _port_class(src, orig, depth + 1)
    return None


def _port_methods(rel, name):
    """Every method name the port's class has: its own and, through its
    bases within the port's sources, the inherited ones."""
    found = _port_class(rel, name)
    if found is None:
        return None
    seen, todo, names = set(), [found], set()
    while todo:
        mod, cls = todo.pop()
        if (mod, cls.name) in seen:
            continue
        seen.add((mod, cls.name))
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        for base in cls.bases:
            if isinstance(base, ast.Name):
                up = _port_class(mod, base.id)
                if up is not None:
                    todo.append(up)
    return names


def public_names(rel):
    """The JAX module's public surface: ``name`` for module-level functions,
    classes and exports, ``Class.method`` for methods."""
    tree = _tree(JAX_PKG, rel)
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            out.append(node.name)
            if isinstance(node, ast.ClassDef):
                out += [f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not m.name.startswith("_")]
    if os.path.basename(rel) == "__init__.py":
        out += [n for n in _exports(tree) if n not in out]
    return out


def _has(rel, name):
    """Whether the port's module ``rel`` has ``name`` (or ``Class.method``)."""
    tree = _tree(PORT_PKG, rel)
    if tree is None:
        return False
    if "." in name:
        cls, meth = name.split(".", 1)
        methods = _port_methods(rel, cls)
        return methods is not None and meth in methods
    if name not in _bindings(tree):
        return False
    if os.path.basename(rel) == "__init__.py":
        exported = _exports(tree)
        return name in exported or not any(
            isinstance(n, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__"
                                              for t in n.targets) for n in tree.body)
    return True


def missing(rel):
    """The JAX module's public names with no counterpart, as ``module::name``."""
    out = []
    for name in public_names(rel):
        key = f"{rel}::{name}"
        if key in JAX_ONLY:
            continue
        targets = RENAMED.get(key, f"{rel}::{name}")
        targets = (targets,) if isinstance(targets, str) else targets
        if not all(_has(*t.split("::")) for t in targets):
            out.append(key)
    return out


MODULES = _modules(JAX_PKG)


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_has_a_counterpart(rel):
    assert missing(rel) == []


def test_tables_name_what_exists():
    """Each row of the two tables names a public name of the JAX package;
    each rename's targets exist in the port, and a JAX-only name has no
    counterpart of its own name."""
    for key in list(RENAMED) + list(JAX_ONLY):
        rel, name = key.split("::")
        assert name in public_names(rel), key
    for key, targets in RENAMED.items():
        for t in (targets,) if isinstance(targets, str) else targets:
            assert _has(*t.split("::")), (key, t)
    for key in JAX_ONLY:
        rel, name = key.split("::")
        assert not _has(rel, name), key


def test_the_walk_sees_the_whole_surface():
    """The walk reaches every module, follows inheritance within the port
    (``NavigationEnv.get_success`` from ``_TargetEnv``, ``HoverEnv.
    get_observation`` from ``DroneGymEnv``), and reads exports."""
    assert len(MODULES) > 50 and "render/sphere_trace.py" in MODULES
    assert "NavigationEnv.get_success" in public_names("envs/navigation.py")
    assert _has("envs/navigation.py", "NavigationEnv.get_success")
    assert "get_success" not in {n.name for n in _port_class("envs/navigation.py",
                                                             "NavigationEnv")[1].body
                                 if isinstance(n, ast.FunctionDef)}
    assert _has("envs/hover.py", "HoverEnv.get_observation")
    assert "extend_state" in public_names("dynamics/__init__.py")
    assert not _has("render/sphere_trace.py", "no_such_function")
    assert not _has("no_such_module.py", "render_camera")
