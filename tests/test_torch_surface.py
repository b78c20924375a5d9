"""The port does all that the JAX package does, checked by name.

Both trees are read with ``ast`` (nothing is imported): every public
top-level function and class of every module of ``fastqdedup_tpu`` must
have a same-named counterpart in the same-named module of
``fastqdedup_tpu_torch``, or in the module ``MOVED`` names, or stand in
``NOT_PORTED`` with its reason.  No file of the port, and not
``chip_smoke.py``, may import ``jax`` or the JAX package.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PACKAGE = os.path.join(REPO, "fastqdedup_tpu")
PORT = os.path.join(REPO, "fastqdedup_tpu_torch")

# (module of the JAX package, name) -> module of the port that holds it.
MOVED = {
    # The Pallas kernels became CUDA kernels behind wrappers of the same
    # names (ops/*_kernels.py); the host-side helpers beside them moved
    # to the module that uses them.
    ("ops/pallas_hamming.py", "bucket_within_packed"):
        "ops/hamming_kernels.py",
    ("ops/pallas_hamming.py", "within_tile_packed"):
        "ops/hamming_kernels.py",
    ("ops/pallas_hamming.py", "rowwise_within_packed"):
        "ops/hamming_kernels.py",
    ("ops/pallas_hamming.py", "unpack_within"): "ops/hamming.py",
    ("ops/pallas_hamming.py", "within_tile_kernel"): "ops/hamming.py",
    ("ops/pallas_edit.py", "banded_within_edit_distance"):
        "ops/edit_kernels.py",
}

# (module, name) -> why the port has no counterpart.
NOT_PORTED = {
    ("ops/labels.py", "dense_cluster_labels"):
        "dense oracle only; the port's tests import it from the JAX "
        "package",
    ("ops/labels.py", "highest_count_representatives"):
        "dense oracle only (ops/labels.py)",
    ("ops/labels.py", "dedup_step"): "dense oracle only (ops/labels.py)",
    ("runtime.py", "configure_jax"):
        "sets up JAX's compilation cache; the port's one setting of its "
        "own is FASTQDEDUP_TORCH_DEVICE (runtime.device)",
    ("native/gen_score_lut.py", "generate"):
        "writes the header of the shared C source, which the port builds "
        "by path and does not fork",
    ("native/gen_score_lut.py", "main"):
        "as generate (native/gen_score_lut.py)",
}


def _modules(root):
    """Relative path -> parsed module, for every .py file under root."""
    found = {}
    for directory, subdirs, files in os.walk(root):
        subdirs[:] = [d for d in subdirs if d not in ("__pycache__", "build")]
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(directory, name)
                with open(path, encoding="utf-8") as f:
                    found[os.path.relpath(path, root)] = ast.parse(f.read())
    return found


def _public_names(tree):
    return {node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef))
            and not node.name.startswith("_")}


def _top_level_names(tree):
    names = {node.name for node in tree.body
             if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef))}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


JAX_MODULES = _modules(JAX_PACKAGE)
PORT_MODULES = _modules(PORT)


@pytest.mark.parametrize("module", sorted(JAX_MODULES))
def test_every_public_name_has_a_counterpart(module):
    missing = []
    for name in sorted(_public_names(JAX_MODULES[module])):
        if (module, name) in NOT_PORTED:
            continue
        home = MOVED.get((module, name), module)
        if home not in PORT_MODULES or \
                name not in _top_level_names(PORT_MODULES[home]):
            missing.append(f"{module}:{name} (looked in {home})")
    assert not missing, missing


def test_tables_name_real_things():
    """Every entry of ``MOVED`` and ``NOT_PORTED`` names a public name
    the JAX package really has, no name stands in both, and nothing in
    ``NOT_PORTED`` exists in the port after all."""
    for module, name in list(MOVED) + list(NOT_PORTED):
        assert name in _public_names(JAX_MODULES[module]), (module, name)
    assert not set(MOVED) & set(NOT_PORTED)
    for (module, name), reason in NOT_PORTED.items():
        assert reason
        assert module not in PORT_MODULES or \
            name not in _top_level_names(PORT_MODULES[module]), (module, name)


def test_every_module_has_a_counterpart():
    """Module by module: the JAX package's files are the port's, apart
    from the Pallas modules (now ops/*_kernels.py) and those whose every
    public name stands in ``NOT_PORTED``."""
    accounted = {module for module, _ in list(MOVED) + list(NOT_PORTED)}
    missing = [module for module in JAX_MODULES
               if module not in PORT_MODULES and module not in accounted]
    assert not missing, missing
    for module in ("ops/hamming_kernels.py", "ops/edit_kernels.py",
                   "ops/kernel_lib.py", "warmup.py"):
        assert module in PORT_MODULES


def _imported_roots(tree):
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        trees = {"chip_smoke.py": ast.parse(f.read())}
    trees.update({os.path.join("fastqdedup_tpu_torch", module): tree
                  for module, tree in PORT_MODULES.items()})
    bad = {path: sorted(_imported_roots(tree)
                        & {"jax", "jaxlib", "fastqdedup_tpu"})
           for path, tree in trees.items()}
    assert not {path: roots for path, roots in bad.items() if roots}


def test_stubs_and_marker_ship_with_the_port():
    """The type stubs and ``py.typed`` of the JAX package have their
    counterparts, and the packaging names them."""
    for name in ("distance.pyi", "quality.pyi", "trie.pyi", "py.typed"):
        assert os.path.exists(os.path.join(JAX_PACKAGE, name))
        assert os.path.exists(os.path.join(PORT, name)), name
    with open(os.path.join(REPO, "pyproject.toml"), encoding="utf-8") as f:
        line = [row for row in f if row.startswith('"fastqdedup_tpu_torch"')]
    assert len(line) == 1 and "py.typed" in line[0] and "*.pyi" in line[0]
    # Each stub declares what its module defines.
    for stub in ("distance", "quality", "trie"):
        with open(os.path.join(PORT, stub + ".pyi"), encoding="utf-8") as f:
            declared = _top_level_names(ast.parse(f.read()))
        defined = _top_level_names(PORT_MODULES[stub + ".py"])
        assert declared and declared <= defined, declared - defined
