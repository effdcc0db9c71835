"""The port's surface against the JAX package's: every public name of
``mcraw`` has a place in ``mcraw_torch``.

Each module of ``mcraw/`` is read with ``ast`` (nothing of it is imported,
so no JAX). Each public top-level function, class and constant, and each
public method of a public class, is in exactly one of three groups:

(a) the same name exists in the same module path of ``mcraw_torch``;
(b) :data:`ROUTED`: an entry point routed to a port function of another
    name, which is resolved by import and, for a function or a class, must
    be callable;
(c) :data:`EXCLUDED`, with one reason of :data:`REASONS`.

A stale entry fails its module's case: a routed or excluded name that
``mcraw`` no longer has, or a name in more than one group. For the
user-facing modules (:data:`USER_FACING`) each function of group (a), and
each public class's constructor, accepts every parameter of the
reference's, or the parameter is in :data:`PARAMS_EXCLUDED` with its
reason. The kernel modules' internal signatures are out of scope.
"""

import ast
import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
MCRAW = ROOT / "mcraw"

REASONS = {
    # ROADMAP's "not ported" list: the TPU's workarounds, its constants and
    # helpers (an H100 reads device memory by address).
    "tpu_machinery",
    # takes or builds a JAX plan (host arrays laid out for a Pallas grid).
    "jax_plan",
    # an option that selects among JAX paths: interpret=, use_table=,
    # kernel=, backend=.
    "jax_only_option",
    # PyTorch spells it differently; the entry names the port's spelling.
    "torch_idiom",
    # a NumPy-oracle helper that a plain version of the port computes
    # inline; the entry names that plain version.
    "inlined_in_plain",
}

_PU = "mcraw.kernels.pallas_unpack."
_PL = "mcraw.kernels.pallas_legacy."
_TU = "mcraw_torch.kernels.unpack."
_TL = "mcraw_torch.kernels.legacy."

# Entry points routed to the port function that computes them (ROADMAP
# queue 2; the NumPy oracle's decodes to the port's CPU computation).
ROUTED = {
    _PU + "decode_modern_pallas": _TU + "decode_modern_frame",
    _PU + "decode_modern_pallas_v5": _TU + "decode_modern_frame",
    _PU + "decode_modern_device_v6": _TU + "decode_modern_device",
    _PU + "decode_modern_pallas_batch": _TU + "decode_modern_batch",
    _PU + "decode_modern_pallas_batch_v5": _TU + "decode_modern_batch",
    _PU + "decode_modern_device_v6_batch": _TU + "decode_modern_batch_device",
    _PU + "prepare_modern_light": _TU + "prepare_modern",
    _PL + "decode_legacy_pallas": _TL + "decode_legacy",
    _PL + "decode_legacy_pallas_v5": _TL + "decode_legacy",
    _PL + "decode_legacy_device_v6": _TL + "decode_legacy_device",
    _PL + "decode_legacy_pallas_batch_v5": _TL + "decode_legacy_batch",
    _PL + "decode_legacy_device_v6_batch": _TL + "decode_legacy_batch_device",
    _PL + "prepare_legacy_light": _TL + "prepare_legacy",
    "mcraw.kernels.pallas_develop.develop_rgba_pallas":
        "mcraw_torch.kernels.develop.develop_rgba_device",
    "mcraw.kernels.pallas_develop.pack_develop_params":
        "mcraw_torch.kernels.develop.pack_develop_params",
    "mcraw.kernels.unpack.decode_modern": _TU + "decode_modern_frame",
    "mcraw.kernels.unpack.decode_legacy": _TL + "decode_legacy",
    "mcraw.kernels.unpack.decode_legacy_device": _TL + "decode_legacy_device",
    "mcraw.kernels.unpack.prepare_legacy": _TL + "prepare_legacy",
    "mcraw.kernels.unpack.LEGACY_PARALLEL_MIN_BLOCKS": _TL + "LEGACY_PARALLEL_MIN_BLOCKS",
    # mcraw_torch.decode_modern(..., device="cpu"): the plain CPU decode.
    "mcraw.kernels.numpy_ref.decode_modern": "mcraw_torch.codecs.decode_modern",
    "mcraw.kernels.numpy_ref.decode_legacy": "mcraw_torch.codecs.decode_legacy",
    "mcraw.kernels.numpy_ref.legacy_scan": "mcraw_torch.kernels.native.legacy_scan",
    "mcraw.kernels.numpy_ref.decode_metadata_stream":
        "mcraw_torch.kernels.native.decode_metadata_stream",
    "mcraw.parallel.decode_frames_pallas_mesh": "mcraw_torch.parallel.decode_frames_batched",
    "mcraw.parallel.decode_frames_legacy_mesh": "mcraw_torch.parallel.decode_frames_batched",
    "mcraw.parallel.decode_frames_v6_mesh": "mcraw_torch.parallel.decode_frames_batched",
    "mcraw.parallel.decode_frames_legacy_v6_mesh":
        "mcraw_torch.parallel.decode_frames_batched",
    "mcraw.parallel.decode_frame_sharded_legacy": "mcraw_torch.parallel.decode_frame_sharded",
}


def _tpu(*names: str) -> dict:
    return {n: ("tpu_machinery", None) for n in names}


def _plan(*names: str) -> dict:
    return {n: ("jax_plan", None) for n in names}


# name -> (reason, the port's name for torch_idiom / inlined_in_plain: one
# dotted path or a tuple of them, else None).
EXCLUDED = {
    **_tpu(*(_PU + n for n in (
        "BLOCKS_PER_CHUNK", "SUBGROUPS", "SUBGROUPS_V5", "TARGET_SG_V5", "UNIFORM16",
        "PAYLOAD_BUCKET_ROWS", "SUB_ROWS_STEP", "ROWS_STEP", "V6_MAX_PAYLOAD",
        "v5_required_fields", "v5_required_fields_cls", "v5_required_fields_mask",
        "v5_geometry", "v5_chunk_span_rows", "v5_content_spans"))),
    **_tpu(*(_PL + n for n in (
        "BLOCKS_PER_CHUNK", "ROWS_PER_CHUNK_LEG", "LEGACY_PAYLOAD_BUCKET_ROWS",
        "LEGACY_ROWS_STEP"))),
    **_tpu("mcraw.kernels.pallas_develop.BAND_ROWS",
           "mcraw.kernels.pallas_develop.BAND_ROWS_COMPUTE",
           "mcraw.kernels.structured.MODERN_STRUCTURED",
           "mcraw.kernels.structured.LEGACY_STRUCTURED",
           "mcraw.kernels.native.length_segments",
           "mcraw.kernels.native.length_segments2"),
    **_tpu(*("mcraw.kernels.unpack." + n for n in (
        "pad_or_window", "unpack_select", "gather_windows_modern", "gather_windows_legacy",
        "modern_deinterleave_jnp", "legacy_interleave_jnp"))),
    **_plan(*(_PU + n for n in (
        "prepare_chunked", "prepare_chunked_v4", "prepare_chunked_v5", "stack_chunked",
        "stack_chunked_v5"))),
    **_plan(*(_PL + n for n in (
        "prepare_chunked_legacy", "prepare_chunked_legacy_v5", "stack_chunked_legacy_v5",
        "prepare_device_legacy_v5"))),
    **_plan("mcraw.kernels.unpack.ModernPlan", "mcraw.kernels.unpack.LegacyPlan",
            "mcraw.parallel.stack_plans", "mcraw.parallel.stack_plans_pallas_v5",
            "mcraw.parallel.batched_decoder"),
    "mcraw.pipeline.Decoder.backend": ("jax_only_option", None),
    "mcraw.kernels.numpy_ref.unpack_blocks": (
        "inlined_in_plain", (_TU + "decode_modern_plain", _TL + "decode_legacy_plain")),
    "mcraw.kernels.numpy_ref.modern_deinterleave": (
        "inlined_in_plain", _TU + "decode_modern_plain"),
    "mcraw.kernels.numpy_ref.legacy_interleave": (
        "inlined_in_plain", _TL + "decode_legacy_plain"),
    # The 2-byte block header the legacy host scan steps over.
    "mcraw.kernels.numpy_ref.HEADER_LENGTH": (
        "inlined_in_plain", "mcraw_torch.kernels.native.legacy_scan"),
}

USER_FACING = ("pipeline", "preview", "clip", "cli", "container", "metadata", "color",
               "encode", "emit", "emit.dng", "emit.wav", "observe", "parallel",
               "distributed")

# reference function -> {parameter: (reason, the port's parameter or None)}
PARAMS_EXCLUDED = {
    "mcraw.pipeline.Decoder": {"backend": ("jax_only_option", None),
                               "kernel": ("jax_only_option", None)},
    # jit's static shapes and the normalizer table passed as a runtime
    # argument: a torch tensor carries its shape, and the port builds the
    # table from it.
    "mcraw.preview.develop": {"height": ("torch_idiom", "raw_u16"),
                              "width": ("torch_idiom", "raw_u16"),
                              "inv_dens": ("torch_idiom", "raw_u16")},
    "mcraw.preview.develop_rgba": {"height": ("torch_idiom", "raw_u16"),
                                   "width": ("torch_idiom", "raw_u16"),
                                   "use_table": ("jax_only_option", None),
                                   "interpret": ("jax_only_option", None)},
    "mcraw.parallel.decode_frames_batched": {"plans": ("jax_plan", None),
                                             "kernel": ("jax_only_option", None)},
    "mcraw.parallel.decode_frame_sharded": {"plan": ("jax_plan", None),
                                            "interpret": ("jax_only_option", None)},
    # gloo's init_method (tcp://host:port) is JAX's coordinator address;
    # local_device_count sets JAX's count of virtual CPU devices, which a
    # torch process does not have (its devices are the Mesh it is given).
    "mcraw.distributed.initialize": {"coordinator_address": ("torch_idiom", "init_method"),
                                     "local_device_count": ("jax_only_option", None)},
}


def _module_name(path: Path) -> str:
    parts = path.relative_to(MCRAW).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


MODULES = sorted(_module_name(p) for p in MCRAW.rglob("*.py"))


def _tree(module: str) -> ast.Module:
    rel = Path(*module.split(".")) if module else Path()
    path = MCRAW / rel / "__init__.py" if (MCRAW / rel).is_dir() else MCRAW / f"{rel}.py"
    return ast.parse(path.read_text())


def _public(module: str) -> dict:
    """{qualified name: ast node} of the module's public functions, classes,
    constants and public methods of its public classes."""
    prefix = "mcraw." + module + "." if module else "mcraw."
    out = {}
    for node in _tree(module).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out[prefix + node.name] = node
            if isinstance(node, ast.ClassDef):
                for m in node.body:
                    if (isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                            and not m.name.startswith("_")):
                        out[f"{prefix}{node.name}.{m.name}"] = m
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and not t.id.startswith("_"):
                    out[prefix + t.id] = node
    return out


def _resolve(dotted: str):
    """The object at a dotted path, importing the longest module prefix;
    None where it does not exist."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr, None)
            if obj is None:
                return None
        return obj
    return None


def _port_name(name: str) -> str:
    return "mcraw_torch" + name[len("mcraw"):]


def _module_of(name: str) -> str:
    """The mcraw module that a listed name belongs to (the longest module
    path that prefixes it)."""
    best = None
    for m in MODULES:
        prefix = "mcraw." + m + "." if m else "mcraw."
        if name.startswith(prefix) and (best is None or len(m) > len(best)):
            best = m
    return best


def _targets(port) -> tuple:
    return port if isinstance(port, tuple) else (port,)


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_one_place(module):
    names = _public(module)
    problems = []
    for name, node in names.items():
        same = _resolve(_port_name(name)) is not None
        groups = [g for g, hit in (("same name", same), ("ROUTED", name in ROUTED),
                                   ("EXCLUDED", name in EXCLUDED)) if hit]
        if len(groups) != 1:
            problems.append(f"{name}: in {groups or 'no group'}")
        if name in ROUTED:
            target = _resolve(ROUTED[name])
            callable_needed = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                                ast.ClassDef))
            if target is None or (callable_needed and not callable(target)):
                problems.append(f"{name}: routed to {ROUTED[name]}, which is not "
                                f"{'callable' if target is not None else 'there'}")
    for table in (ROUTED, EXCLUDED):
        for name in table:
            if _module_of(name) == module and name not in names:
                problems.append(f"{name}: listed, but mcraw.{module} has no such name")
    for name, (reason, port) in EXCLUDED.items():
        if _module_of(name) != module:
            continue
        if reason not in REASONS:
            problems.append(f"{name}: reason {reason!r} is not one of {sorted(REASONS)}")
        if reason in ("inlined_in_plain", "torch_idiom"):
            missing = [t for t in _targets(port or ()) if _resolve(t) is None]
            if port is None or missing:
                problems.append(f"{name}: {reason} names no port function ({missing})")
    assert not problems, "\n".join(problems)


def test_every_listed_name_is_in_a_module():
    """A routed or excluded name whose module is gone would fall outside
    every case above."""
    listed = [*ROUTED, *EXCLUDED, *PARAMS_EXCLUDED]
    assert not [n for n in listed if _module_of(n) is None]
    assert not set(ROUTED) & set(EXCLUDED)


def _params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    names = [n for n in names if n not in ("self", "cls")]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    return names


def _is_property(fn) -> bool:
    return any(isinstance(d, ast.Name) and d.id == "property" for d in fn.decorator_list)


def _signatures(module: str) -> dict:
    """{reference name: its parameters} for the module's public functions
    and the constructors (``__init__``) of its public classes."""
    prefix = "mcraw." + module + "."
    out = {}
    for node in _tree(module).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[prefix + node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for m in node.body:
                if not isinstance(m, ast.FunctionDef) or _is_property(m):
                    continue
                if m.name == "__init__":
                    out[prefix + node.name] = _params(m)
                elif not m.name.startswith("_"):
                    out[f"{prefix}{node.name}.{m.name}"] = _params(m)
    return out


@pytest.mark.parametrize("module", USER_FACING)
def test_ported_functions_take_the_reference_parameters(module):
    problems = []
    sigs = _signatures(module)
    for name, params in sigs.items():
        port = _resolve(_port_name(name))
        if port is None:
            continue  # routed or excluded: the case above holds it
        sig = inspect.signature(port)
        kinds = {p.kind for p in sig.parameters.values()}
        excluded = PARAMS_EXCLUDED.get(name, {})
        for p in params:
            if p.startswith("**"):
                ok = inspect.Parameter.VAR_KEYWORD in kinds
            elif p.startswith("*"):
                ok = inspect.Parameter.VAR_POSITIONAL in kinds
            else:
                ok = p in sig.parameters or inspect.Parameter.VAR_KEYWORD in kinds
            if ok and p in excluded:
                problems.append(f"{name}({p}=): the port takes it, but it is excluded")
            elif not ok and p not in excluded:
                problems.append(f"{name}({p}=): the port does not take it")
        for p, (reason, port_param) in excluded.items():
            if p not in params:
                problems.append(f"{name}({p}=): excluded, but the reference has no {p}")
            if reason not in REASONS:
                problems.append(f"{name}({p}=): reason {reason!r}")
            if reason == "torch_idiom" and port_param not in sig.parameters:
                problems.append(f"{name}({p}=): the port has no {port_param}")
    for name in PARAMS_EXCLUDED:
        if _module_of(name) == module and name not in sigs:
            problems.append(f"{name}: parameters excluded, but it is not a function here")
    assert not problems, "\n".join(problems)
