"""The reference's whole public surface in the port, module by module.

One case per module of ``src/repro/``: every public function and class
the module defines has its counterpart in the ``repro_torch`` module of
the same path, taking every parameter the reference's takes (by name);
every public method and property of those classes too; a package's
``__init__`` binds every public name the reference's binds.  A
difference passes only through the tables below, one reason each: the
"not to port" list of ROADMAP §1 and the parameters the port drops or
renames on purpose.  A table entry that no longer describes a difference
fails too, so the tables stay exact.

The reference is read from its source (``ast``), not imported: importing
``repro.launch.dryrun`` would force 512 host devices on this process.
The port's modules are imported and inspected; nothing runs.
"""
import ast
import dataclasses
import importlib
import inspect
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "src", "repro")
PORT = os.path.join(REPO, "src", "repro_torch")

_INTERPRET = "Pallas interpret mode: the port's plain versions take its role"
_TILES = ("a Pallas tiling knob: the CUDA kernels tile by the warp width "
          "(src/repro_torch/kernels/attn/ops.py:5-6)")
_SINKS = ("the g: sinks only carry backward statistics; the port's serving "
          "steps run without autograd")

# Reference modules the port does not have: (reason, port files in their
# place, relative to src/repro_torch).
NOT_PORTED_MODULES = {
    "_jax_compat.py": ("jax shims (jax.set_mesh, jax.shard_map, AxisType "
                       "on jax 0.4.x): the port imports no jax", ()),
    "kernels/attn/attn_kernel.py": (
        "the Pallas sources of K3 and K5, ported as CUDA",
        ("kernels/attn/csrc/flash_decode.cu",
         "kernels/attn/csrc/flash_decode_paged.cu")),
    "kernels/attn/prefill_kernel.py": (
        "the Pallas sources of K4 and K6, ported as CUDA",
        ("kernels/attn/csrc/flash_prefill.cu",
         "kernels/attn/csrc/flash_prefill_paged.cu")),
    "kernels/dfxp/dfxp_kernel.py": (
        "the Pallas source of K1, ported as CUDA",
        ("kernels/dfxp/csrc/dfxp_quantize.cu",)),
    "kernels/qmatmul/qmatmul_kernel.py": (
        "the Pallas source of K2, ported as CUDA",
        ("kernels/qmatmul/csrc/qmatmul.cu",)),
}

# Public names of a ported module that the port does not define.
NOT_PORTED = {
    ("kernels/_tiling.py", "default_interpret"): _INTERPRET,
    ("kernels/_tiling.py", "resolve_interpret"): _INTERPRET,
    ("kernels/_tiling.py", "mm_blocks"): "TPU tile sizes",
    ("kernels/_tiling.py", "quantize_blocks"): "TPU tile sizes",
    ("data/synthetic.py", "shard_batch"): (
        "a jax.device_put; dist.sharding.shard_tree is the port's"),
    ("data/__init__.py", "shard_batch"): "the re-export of the above",
    ("launch/dryrun.py", "collective_bytes"): (
        "parses partitioned HLO; the port's implied_collectives reads the "
        "sharding rules"),
}

# (module, qualified name) -> (reference parameters the port drops,
# {reference name: port name}, reason).
PARAMS = {
    ("core/quant.py", "enable_pallas_quantize"): (
        {"interpret"}, {}, _INTERPRET),
    ("kernels/attn/ops.py", "flash_decode"): (
        {"block_w", "interpret"}, {}, _TILES),
    ("kernels/attn/ops.py", "flash_prefill"): (
        {"block_w", "interpret"}, {}, _TILES),
    ("kernels/attn/ops.py", "flash_decode_paged"): (
        {"force_split", "interpret"}, {}, _TILES),
    ("kernels/attn/ops.py", "flash_prefill_paged"): (
        {"force_split", "interpret"}, {}, _TILES),
    ("kernels/dispatch.py", "fused_dot"): (
        {"cast", "interpret"}, {},
        "cast is the MXU operand dtype; K2 multiplies at f32 accuracy on "
        "TF32 (hi + lo) always"),
    ("kernels/dfxp/ops.py", "dfxp_quantize"): ({"interpret"}, {}, _INTERPRET),
    ("kernels/dispatch.py", "tape_dot"): ({"interpret"}, {}, _INTERPRET),
    ("kernels/qmatmul/ops.py", "qmatmul"): ({"interpret"}, {}, _INTERPRET),
    ("kernels/qmatmul/ops.py", "qmm"): (
        {"cast", "interpret", "out_dtype"}, {"blocks": "plan"},
        "K2 takes a launch plan (bn, splits, per) for the TPU's blocks and "
        "computes to float32 (src/repro_torch/kernels/qmatmul/ops.py:3-10)"),
    ("kernels/qmatmul/ref.py", "qmatmul_ref"): (
        {"width", "quant_a", "quant_b", "transpose_b", "grad_width", "e_g"},
        {}, "the plain K2 takes K2's own form (kind nn/nt/tn, a width per "
        "operand); the fused_dot form is kernels.dispatch.fused_dot's"),
    ("launch/dryrun.py", "run_cell"): (
        set(), {"hlo_dir": "ops_dir"},
        "the port records a census of aten operations, not HLO"),
    ("models/layers.py", "AttnSpec"): (
        {"use_rope"}, {}, "no reference config or call turns RoPE off"),
    ("models/layers.py", "attention_decode"): (
        set(), {"pos": "positions"},
        "the positions tensor is named as apply_rope's argument"),
    ("models/transformer.py", "forward"): (
        {"max_cache_len"}, {},
        "the port's forward runs the train and hidden modes; prefill, "
        "which builds the cache, takes max_cache_len"),
    ("models/transformer.py", "prefill"): ({"sinks"}, {}, _SINKS),
    ("models/transformer.py", "decode_step"): (
        {"sinks"}, {"tokens_or_embeds": "tokens"},
        _SINKS + "; tokens are ids or embeds, as the input mode says"),
    ("models/transformer.py", "prefill_chunk_step"): ({"sinks"}, {}, _SINKS),
    ("serve/kv_pool.py", "make_kv_pool"): (
        {"fused_decode"}, {}, "deprecated in the reference "
        "(src/repro/serve/kv_pool.py:131-135): policy.fused_decode sets it"),
}


def _ref_modules():
    out = []
    for d, _, files in os.walk(REF):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(d, f), REF))
    return sorted(out)


MODULES = _ref_modules()


def _port_name(rel: str) -> str:
    parts = rel[:-3].split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["repro_torch"] + parts)


# ---------------------------------------------------------------------------
# the reference's surface, from its source
# ---------------------------------------------------------------------------

def _params(fn: ast.FunctionDef, drop_first=False) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names[1:] if drop_first else names


def _decorators(node) -> set:
    out = set()
    for d in node.decorator_list:
        d = d.func if isinstance(d, ast.Call) else d
        out.add(d.attr if isinstance(d, ast.Attribute) else
                getattr(d, "id", ""))
    return out


def _dataclass_fields(cls: ast.ClassDef) -> list:
    out = []
    for node in cls.body:
        if not (isinstance(node, ast.AnnAssign)
                and isinstance(node.target, ast.Name)):
            continue
        if "ClassVar" in ast.unparse(node.annotation):
            continue
        v = node.value
        if isinstance(v, ast.Call) and any(
                k.arg == "init" and isinstance(k.value, ast.Constant)
                and k.value.value is False for k in v.keywords):
            continue
        out.append(node.target.id)
    return out


def _class_surface(cls: ast.ClassDef):
    """``(constructor parameters or None, {public member: parameters, or
    None for a property})``."""
    init, members = None, {}
    for node in cls.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name == "__init__":
            init = _params(node, drop_first=True)
        elif not node.name.startswith("_"):
            decos = _decorators(node)
            if decos & {"property", "cached_property"}:
                members[node.name] = None
            else:
                members[node.name] = _params(
                    node, drop_first="staticmethod" not in decos)
    if init is None and "dataclass" in _decorators(cls):
        init = _dataclass_fields(cls)
    if init is None and any(getattr(b, "id", getattr(b, "attr", ""))
                            == "NamedTuple" for b in cls.bases):
        init = _dataclass_fields(cls)
    return init, members


def _top_level(body):
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_level(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_level(node.body)
        else:
            yield node


def _own_import(node) -> bool:
    """An import from the package itself (a re-export), not from the
    standard library, typing, jax or numpy."""
    if isinstance(node, ast.ImportFrom):
        return node.level > 0 or (node.module or "").split(".")[0] in (
            "repro", "repro_torch")
    return False


def _ref_surface(rel: str):
    """``(functions {name: params}, classes {name: (init, members)},
    names it defines, names it re-exports)`` of a reference module's top
    level, public ones only."""
    with open(os.path.join(REF, rel)) as f:
        tree = ast.parse(f.read())
    funcs, classes, bound, exported = {}, {}, set(), set()
    for node in _top_level(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            bound.add(node.name)
            funcs[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            bound.add(node.name)
            classes[node.name] = _class_surface(node)
        elif isinstance(node, ast.ImportFrom) and _own_import(node):
            exported.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else \
                [node.target]
            # a name the module binds to jax's own (``Array = jax.Array``)
            # is jax's, not the module's
            if node.value is not None and any(
                    isinstance(n, ast.Name) and n.id in ("jax", "jnp")
                    for n in ast.walk(node.value)):
                continue
            bound.update(t.id for t in targets if isinstance(t, ast.Name))
    return ({n: p for n, p in funcs.items() if not n.startswith("_")},
            {n: c for n, c in classes.items() if not n.startswith("_")},
            {n for n in bound if not n.startswith("_")},
            {n for n in exported if not n.startswith("_")})


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

def _port_params(obj) -> list:
    sig = inspect.signature(obj)
    return [p.name for p in sig.parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _check_params(rel, qual, ref: list, port: list) -> list:
    dropped, renamed, _ = PARAMS.get((rel, qual), (set(), {}, ""))
    bad = []
    for p in ref:
        if p in dropped:
            continue
        if renamed.get(p, p) not in port:
            bad.append(f"{qual}: parameter {p!r} missing (port has "
                       f"{port})")
    for p in dropped:
        if p not in ref or p in port:
            bad.append(f"{qual}: the table drops {p!r}, which is no "
                       f"longer a difference")
    for old, new in renamed.items():
        if old not in ref or new not in port or old in port:
            bad.append(f"{qual}: the table renames {old!r} -> {new!r}, "
                       f"which is no longer the difference")
    return bad


def _is_property_like(port_cls, name) -> bool:
    try:
        attr = inspect.getattr_static(port_cls, name)
    except AttributeError:
        attr = None
    if isinstance(attr, (property,)) or type(attr).__name__ == \
            "cached_property":
        return True
    return dataclasses.is_dataclass(port_cls) and name in {
        f.name for f in dataclasses.fields(port_cls)}


def _check_class(rel, name, ref_cls, port_cls) -> list:
    init, members = ref_cls
    bad = []
    if init is not None:
        bad += _check_params(rel, name, init, _port_params(port_cls))
    for m, params in members.items():
        qual = f"{name}.{m}"
        if params is None:
            if not _is_property_like(port_cls, m):
                bad.append(f"{qual}: property missing")
            continue
        try:
            attr = inspect.getattr_static(port_cls, m)
        except AttributeError:
            bad.append(f"{qual}: method missing")
            continue
        fn = attr.__func__ if isinstance(attr, (staticmethod, classmethod)) \
            else attr
        if not callable(fn):
            bad.append(f"{qual}: not a method in the port")
            continue
        got = _port_params(fn)
        if not isinstance(attr, staticmethod):
            got = got[1:]
        bad += _check_params(rel, qual, params, got)
    return bad


def test_tables_name_reference_modules():
    """Every table entry names a module the reference has."""
    keys = list(NOT_PORTED_MODULES) + [m for m, _ in NOT_PORTED] + \
        [m for m, _ in PARAMS]
    assert not [k for k in keys if k not in MODULES]
    assert all(reason for reason, _ in NOT_PORTED_MODULES.values())
    assert all(NOT_PORTED.values())
    assert all(reason for _, _, reason in PARAMS.values())


@pytest.mark.parametrize("rel", MODULES)
def test_module_surface_is_ported(rel):
    name = _port_name(rel)
    if rel in NOT_PORTED_MODULES:
        _, files = NOT_PORTED_MODULES[rel]
        path = os.path.join(PORT, rel)
        assert not os.path.exists(path), \
            f"{rel} is ported now: take it out of NOT_PORTED_MODULES"
        missing = [f for f in files if not os.path.exists(
            os.path.join(PORT, f))]
        assert not missing, missing
        return
    port = importlib.import_module(name)
    funcs, classes, bound, _ = _ref_surface(rel)
    bad = []
    for n in sorted(bound):
        skipped = (rel, n) in NOT_PORTED
        if skipped == hasattr(port, n):
            bad.append(f"{n}: " + ("ported now: take it out of NOT_PORTED"
                                   if skipped else f"missing from {name}"))
    for n, params in funcs.items():
        if hasattr(port, n) and (rel, n) not in NOT_PORTED:
            bad += _check_params(rel, n, params,
                                 _port_params(getattr(port, n)))
    for n, cls in classes.items():
        if hasattr(port, n):
            bad += _check_class(rel, n, cls, getattr(port, n))
    for (m, q) in PARAMS:
        if m == rel and q.split(".")[0] not in funcs and \
                q.split(".")[0] not in classes:
            bad.append(f"{q}: the table names it, the reference does not")
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("rel", [m for m in MODULES
                                 if os.path.basename(m) == "__init__.py"])
def test_package_init_binds_the_references_names(rel):
    """The port's ``__init__`` itself binds each public name the
    reference's defines or re-exports from its package (a submodule
    imported elsewhere does not count)."""
    _, _, defined, exported = _ref_surface(rel)
    ref = defined | exported
    with open(os.path.join(PORT, rel)) as f:
        tree = ast.parse(f.read())
    port = set()
    for node in _top_level(tree.body):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            port.update((a.asname or a.name).split(".")[0]
                        for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            port.add(node.name)
        elif isinstance(node, ast.Assign):
            port.update(t.id for t in node.targets
                        if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            port.add(node.target.id)
    missing = sorted(n for n in ref - port if (rel, n) not in NOT_PORTED)
    assert not missing, missing
