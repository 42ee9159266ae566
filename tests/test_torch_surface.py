"""The port's public surface against the reference's, and the README's
port Quickstart.

For every module of paddlebox_tpu/ (every package __init__ too), each
public top-level name has a counterpart under the same path in
paddlebox_tpu_torch/, or stands in DECLINED with the reason. The names
come from the sources by AST, so nothing of JAX is imported: a module's
defs, classes and assignments; a package's imports, __all__ and lazy
exports besides. A name added to the reference later fails its module's
case until it is ported or declined; a declined name the port has since
ported, or the reference no longer has, fails too. ROADMAP.md A lists
the same declined names.

Then the parameters: for every public function, every public class's
__init__ (a dataclass's fields) and every public method of the
reference that the port defines under the same path (or imports there
from another port module), each reference parameter has a counterpart
of the same name, a positional one at the reference's position (so a
positional call means the same in both), or stands in DECLINED_PARAMS
with the reason, keyed "module path:qualified name:parameter". Extra
parameters of the port after the reference's are free. A declined
parameter the port has since put in place, or the reference no longer
takes, fails its module's case too.

Then the package-level names resolve at run time, the lazy packages
(data, embedding, train) and serving import no torch, and the fenced
block under "Quickstart (port)" in README.md runs as written on the CPU
(its ``device = "cuda"`` made ``"cpu"``)."""

import ast
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "paddlebox_tpu")
PORT = os.path.join(REPO, "paddlebox_tpu_torch")

_REGISTRY = ("the reference's flag registry function: the port reads its "
             "flags into dataclasses passed to the constructors "
             "(config/flags.py; a flag is a field, PBTPU_<NAME> its "
             "override)")
_XLA_PUSH = ("the XLA push rules and their jit factory: every push of the "
             "port is the fused push_adagrad kernel (embedding/"
             "push_kernels.py push_adagrad, push_adagrad_plain its plain "
             "version)")
_PALLAS = ("a Pallas kernel: ported as CUDA C++ (csrc/push_adagrad.cu, "
           "csrc/blocked_write.cu) behind embedding/push_kernels.py "
           "push_adagrad and blocked_write")
_LOADER = ("the reference's build-or-fall-back loader: the port's host "
           "library is built with g++ at first use or raises "
           "(native/host_lib.py build_host_lib, host_lib), and its kernels "
           "load by name (native/build.py load_kernel)")
_ROUTE = ("a binding of the route index: native/host_lib.py, beside the "
          "port's other ctypes bindings")
_MESH_OBS = ("the report transport over the reference's p2p socket mesh: "
             "the port has no socket mesh, and make_transport takes the KV "
             "store's StoreObsTransport (ROADMAP.md C)")
_JIT = ("jax.jit's compile counts and XLA cost analysis: nothing compiles "
        "in the port; obs/device.py instrument_step keeps the signature "
        "sentinel and the donation audit")
_AXIS = ("a jax mesh axis name: the port's node, mp and sp axes are "
         "process groups (ShardMesh.node_group, MeshTowerTrainer(group=), "
         "SeqCtrTrainer(group=))")
_MIXED = ("folded into train/trainer.py model_logits(compute_dtype=): the "
          "forward's bf16 copies; TrainerConfig validates the dtype")
_SUBMODULE = ("the port's ops.data_norm and ops.rank_attention stay the "
              "submodules, each one's function of that name the op (the "
              "port's code and tests import the modules); the reference's "
              "package attributes are the functions, shadowing its own "
              "submodules")
_JAX_SHIM = ("a jax shim: the port's device.py resolve_device picks the "
             "device")

# "module path:name" -> why the port has no counterpart under that path
DECLINED = {
    "config/flags.py:all_flags": _REGISTRY,
    "config/flags.py:define_flag": _REGISTRY,
    "config/flags.py:get_flag": _REGISTRY,
    "config/flags.py:set_flag": _REGISTRY,
    "data/shuffle.py:MeshShuffler":
        "the shuffle over the reference's p2p socket mesh: the port has no "
        "socket mesh, and Fleet.make_shuffler builds the TcpShuffler under "
        "both hostplane values (ROADMAP.md C)",
    "embedding/__init__.py:apply_push": _XLA_PUSH,
    "embedding/__init__.py:make_push_fn": _XLA_PUSH,
    "embedding/optimizers.py:apply_push": _XLA_PUSH,
    "embedding/optimizers.py:make_push_fn": _XLA_PUSH,
    "embedding/optimizers.py:merge_grads_onehot":
        "the MXU one-hot merge behind the declined flag push_onehot_rows: "
        "the port's merge is one ascending-order sum inside the fused push",
    "embedding/optimizers.py:rebuild_uids":
        "rebuilds the uids on the device from (ids, perm, inv) to skip a "
        "transfer: the port's uids come from the host dedup "
        "(pass_table.dedup_ids) or the uid wire (optimizers."
        "decode_delta_uids)",
    "embedding/pallas_push.py:pallas_apply_push": _PALLAS,
    "embedding/pallas_push.py:pallas_blocked_write": _PALLAS,
    "embedding/pass_table.py:first_occurrence_idx":
        "replaced by segment_offsets in PR 3: the fused push reads each "
        "unique's slab row itself, so no pulled row is reused",
    "models/base.py:Logits":
        "a jax type alias of a forward's result: the port's models say it "
        "in models/base.py's docstring ([B] logits, or a dict of them by "
        "task)",
    "native/__init__.py:available": _LOADER,
    "native/__init__.py:get_lib": _LOADER,
    "native/build.py:available": _LOADER,
    "native/build.py:get_lib": _LOADER,
    "native/build.py:load_lib": _LOADER,
    "native/build.py:create_route_index": _ROUTE,
    "native/build.py:destroy_route_index": _ROUTE,
    "native/build.py:route_lookup": _ROUTE,
    "native/build.py:route_lookup_serve": _ROUTE,
    "obs/__init__.py:MeshObsTransport": _MESH_OBS,
    "obs/aggregate.py:MeshObsTransport": _MESH_OBS,
    "obs/__init__.py:instrument_jit": _JIT,
    "obs/device.py:instrument_jit": _JIT,
    "obs/device.py:InstrumentedJit": _JIT,
    "obs/device.py:analyze_compiled": _JIT,
    "obs/tracer.py:set_jax_annotation":
        "hands the spans to jax.profiler: the port's set_annotation takes "
        "any annotation factory (torch.profiler.record_function)",
    "ops/__init__.py:data_norm": _SUBMODULE,
    "ops/__init__.py:rank_attention": _SUBMODULE,
    "parallel/mesh.py:NODE_AXIS": _AXIS,
    "parallel/mesh_tower.py:MP_AXIS": _AXIS,
    "parallel/seq_trainer.py:SP_AXIS": _AXIS,
    "parallel/mesh.py:device_mesh_grid":
        "places the [P, C, W] slab stack on a (table, row) jax mesh: the "
        "port has no slab placement, rank t * R + r is grid position "
        "(t, r) (ROADMAP.md C)",
    "parallel/sharded_table.py:ShardedStoreView":
        "routes rows among the shards of one process: a port process owns "
        "one shard, and store_view() at world 1 is its store (ROADMAP.md "
        "C)",
    "parallel/sharded_table.py:exchange_outgoing_buckets":
        "the store hostplane's all_gather of every source's buckets: the "
        "port's one gloo exchange gives each rank its incoming ids under "
        "both hostplane values (exchange_incoming_p2p, "
        "exchange_push_uids_p2p)",
    "train/__init__.py:TrainStepFns":
        "the jitted step and its metadata: the port's step is eager "
        "PyTorch (train/trainer.py make_train_step, make_scan)",
    "train/trainer.py:TrainStepFns":
        "the jitted step and its metadata: the port's step is eager "
        "PyTorch (train/trainer.py make_train_step, make_scan)",
    "train/trainer.py:apply_mixed_precision": _MIXED,
    "train/trainer.py:cast_for_compute": _MIXED,
    "train/trainer.py:mixed_logits_to_f32": _MIXED,
    "train/trainer.py:resolve_compute_dtype": _MIXED,
    "train/trainer.py:dn_update_params":
        "the model's update_summary (models/ctr_dnn.py), which the "
        "trainers call after the dense step",
    "train/trainer.py:resolve_push_write":
        "PushFlags.resolve_push_write (config/flags.py), one method for "
        "every trainer",
    "train/trainer.py:resolve_push_write_sharded":
        "PushFlags.resolve_push_write (config/flags.py), one method for "
        "every trainer",
    "utils/compat_hook.py:install_deferred": _JAX_SHIM,
    "utils/platform.py:force_cpu_if_requested": _JAX_SHIM,
}


_PUSH_ARGS = ("the push's arguments of the fused kernel: an int ``seed`` "
              "(the kernel's creation hash) for the JAX PRNG key, the host "
              "dedup's n_valid, segment offsets and n_uniq in the places of "
              "inv_sorted and first_idx, and no pulled rows (the kernel "
              "reads each unique's slab row itself); the other arguments "
              "keep their names after them")
_MODULE_PARAMS = ("a JAX params pytree or PRNG key: a port model is a "
                  "torch.nn.Module that holds its parameters (drawn from a "
                  "torch.Generator), so its methods take none and an "
                  "initializer takes the module or an int seed")
_GROUP = ("a jax mesh or mesh axis name: the port's collectives run over a "
          "torch.distributed process group passed in its place (group=, "
          "dp_group=; ShardMesh, AxisMesh)")
_SOCKET_MESH = ("the reference's p2p socket mesh: the port has none; its "
                "host plane is the gloo group of Fleet.make_mesh_comm and "
                "its reports ride the KV store's StoreObsTransport "
                "(ROADMAP.md C)")


def _each(callable_key, params, reason):
    return {"%s:%s" % (callable_key, p): reason for p in params}


# "module path:qualified name:parameter" -> why the port's counterpart has
# no such parameter at the reference's position
DECLINED_PARAMS = {
    **_each("embedding/optimizers.py:push_sparse_dedup",
            ["grads", "prng", "layout", "conf"], _PUSH_ARGS),
    **_each("embedding/optimizers.py:push_sparse_hostdedup",
            ["inv_sorted", "grads", "prng", "layout", "conf", "pulled_rows",
             "first_idx", "write"], _PUSH_ARGS),
    **_each("embedding/optimizers.py:push_sparse_uidwire",
            ["grads", "prng", "layout", "conf", "pulled_rows", "write"],
            _PUSH_ARGS),
    **_each("embedding/optimizers.py:push_sparse_rebuild",
            ["inv_sorted", "grads", "prng", "layout", "conf", "pulled_rows",
             "first_idx"], _PUSH_ARGS),
    **_each("fleet/fleet.py:Fleet.init", ["server", "client"],
            "the reference's own KV store server and client: the port's "
            "fleet rendezvouses through a torch.distributed store "
            "(Fleet.init(store=), a FileStore or TCPStore; default the "
            "role's endpoint)"),
    **_each("fleet/fleet.py:Fleet.make_shuffler", ["mesh"], _SOCKET_MESH),
    **_each("fleet/mesh_comm.py:MeshComm.__init__", ["host", "op_timeout"],
            "the reference's socket mesh listens on ``host`` and times each "
            "op: the port's exchange is a gloo group (group=, its timeout "
            "the fleet's, Fleet.init_distributed(timeout))"),
    **_each("models/bst.py:BstSeqCtr.seq_feature_local",
            ["p", "emb_chunk", "valid_chunk", "axis"],
            _MODULE_PARAMS + "; " + _GROUP),
    **_each("models/bst.py:BstSeqCtr.head_apply", ["p", "pooled", "seq_feat"],
            _MODULE_PARAMS),
    **_each("models/bst.py:BstSeqCtr.oracle_logits",
            ["p", "pooled", "emb_seq", "seq_valid"], _MODULE_PARAMS),
    **_each("models/ctr_dnn.py:CtrDnn.update_summary",
            ["params", "pooled", "dense"], _MODULE_PARAMS),
    **_each("models/layers.py:mlp_init", ["rng"], _MODULE_PARAMS),
    **_each("models/layers.py:mlp_apply", ["params"], _MODULE_PARAMS),
    **_each("models/wide_tower.py:TpDeepFM.apply_local", ["axis"], _GROUP),
    **_each("models/wide_tower.py:EpMMoE.apply_local", ["axis"], _GROUP),
    **_each("obs/__init__.py:make_cluster_aggregator",
            ["mesh", "fleet", "rank", "world"], _SOCKET_MESH),
    **_each("obs/aggregate.py:make_transport", ["mesh", "fleet"],
            _SOCKET_MESH),
    **_each("parallel/mesh.py:init_distributed",
            ["coordinator", "world", "rank"],
            "jax.distributed's coordinator address: the port's process "
            "group is for a device (its first argument) and rendezvouses "
            "through a torch store (store=)"),
    **_each("parallel/mesh.py:device_mesh_2d",
            ["n_nodes", "chips_per_node", "node_axis", "chip_axis"],
            "a jax device mesh with named axes: the port's (node, chip) "
            "view is made from the rank's ShardMesh (its first argument), "
            "the node axis its node_group"),
    **_each("parallel/mesh_tower.py:MeshTowerTrainer.__init__", ["mesh"],
            _GROUP),
    **_each("parallel/pipeline.py:init_stage_params", ["rng"],
            _MODULE_PARAMS),
    **_each("parallel/pipeline.py:dn_summary_apply", ["dp_axis"], _GROUP),
    **_each("parallel/ring_attention.py:ring_attention", ["axis_name"],
            _GROUP),
    **_each("parallel/ring_attention.py:ulysses_attention", ["axis_name"],
            _GROUP),
    **_each("parallel/seq_trainer.py:SeqCtrTrainer.__init__", ["mesh"],
            _GROUP),
    **_each("parallel/sharded_table.py:exchange_push_uids_p2p",
            ["pool", "policy"],
            "the reference's staging thread pool: the port's exchange "
            "routes on the calling thread, so ``policy`` follows ``mesh``"),
    **_each("parallel/sharded_table.py:stage_push_dedup",
            ["buckets", "local_positions", "num_devices", "shard_cap",
             "multiprocess", "all_gather", "rebuild", "pool", "note_touched",
             "uid_only", "mesh", "sort_uids", "policy"],
            "the reference bucketizes, exchanges and dedups a step's push "
            "in one call over every source's buckets; the port's exchange "
            "(exchange_incoming_p2p) gives each rank its incoming ids, "
            "which this function dedups (ROADMAP.md C)"),
    **_each("parallel/sharded_trainer.py:ShardedBoxTrainer.shard_batches",
            ["per_worker"],
            "the per-worker batch lists of the reference's one-process "
            "mesh: a port process stages its own rank's batches"),
    **_each("parallel/tensor_parallel.py:tp_mlp_apply", ["axis"], _GROUP),
    **_each("parallel/tensor_parallel.py:tp_loss_scale", ["axis"], _GROUP),
    **_each("parallel/tensor_parallel.py:tp_fix_grads", ["axis"], _GROUP),
    **_each("parallel/tensor_parallel.py:ep_gate_psum", ["axis"], _GROUP),
    **_each("parallel/tensor_parallel.py:ep_experts_apply", ["axis"],
            _GROUP),
    **_each("train/trainer.py:make_scan", ["extra_carry"],
            "lax.scan's extra carried state: the port's scan is a loop "
            "over the step function, whose state lives in the trainer"),
    **_each("train/trainer.py:make_train_step", ["sparse_chunk"],
            "the chunk-synchronous step is make_chunk_step of its own"),
    **_each("train/trainer.py:make_train_step", ["uid_write"],
            "the uid wire's write: the port's step takes push_write and "
            "wire() (StageFlags.wire)"),
}


def _targets(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [n.id for t in targets for n in ast.walk(t)
            if isinstance(n, ast.Name)]


def _dict_keys(node):
    return ([k.value for k in node.value.keys]
            if isinstance(node.value, ast.Dict) else [])


def names_of(path, package):
    """The public top-level names of a source file: defs, classes and
    assignments; for a package (``package``) its imports, a literal
    __all__ and the keys of a lazy-export dict (_EXPORTS, _HOME) too."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = _targets(node)
            out.update(targets)
            if package and "__all__" in targets:
                try:
                    out.update(ast.literal_eval(node.value))
                except ValueError:    # sorted(_EXPORTS): the dict's keys
                    pass
            if package and {"_EXPORTS", "_HOME"} & set(targets):
                out.update(_dict_keys(node))
        elif package and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")}


def port_names(path):
    """What a port module offers under its path: every top-level name and
    import, and a lazy package's exports."""
    return names_of(path, True) if os.path.exists(path) else set()


def reference_modules():
    out = []
    for root, dirs, files in os.walk(REF):
        dirs[:] = sorted(d for d in dirs if not d.startswith("_"))
        out += [os.path.relpath(os.path.join(root, f), REF)
                for f in sorted(files) if f.endswith(".py")]
    return out


MODULES = reference_modules()


@pytest.mark.parametrize("rel", MODULES)
def test_every_reference_name_is_ported_or_declined(rel):
    ref = names_of(os.path.join(REF, rel), rel.endswith("__init__.py"))
    have = port_names(os.path.join(PORT, rel))
    missing = sorted(n for n in ref - have
                     if "%s:%s" % (rel, n) not in DECLINED)
    assert not missing, ("%s: no counterpart and no reason: %s"
                         % (rel, missing))
    for key in DECLINED:
        mod, name = key.split(":")
        if mod == rel:
            assert name in ref, "%s: declines %r, which it does not " \
                                "define" % (rel, name)
            assert name not in have, "%s: declines %r, which the port " \
                                     "has" % (rel, name)


def test_declined_modules_exist_and_roadmap_lists_them():
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = f.read()
    for key in DECLINED:
        mod, name = key.split(":")
        assert mod in MODULES, key
        assert "`%s`" % name in roadmap, ("ROADMAP.md A does not list the "
                                          "declined %s" % key)


def _is_dataclass(node):
    for d in node.decorator_list:
        f = d.func if isinstance(d, ast.Call) else d
        if getattr(f, "id", getattr(f, "attr", None)) == "dataclass":
            return True
    return False


def _params(fn, method):
    """(positional parameter names, keyword-only names) of a def; a
    method's self or cls left out."""
    a = fn.args
    pos = [x.arg for x in a.posonlyargs + a.args]
    static = any(getattr(d, "id", None) == "staticmethod"
                 for d in fn.decorator_list)
    if method and not static and pos and pos[0] in ("self", "cls"):
        pos = pos[1:]
    return pos, [x.arg for x in a.kwonlyargs]


def _is_property(fn):
    return any(getattr(d, "id", None) == "property"
               or getattr(d, "attr", None) in ("setter", "getter", "deleter")
               for d in fn.decorator_list)


def signatures(path):
    """name -> (positional names, keyword-only names) of a source file's
    public functions, public classes' ``Class.__init__`` (a dataclass's
    init fields when it defines none) and public methods
    (``Class.method``), by AST; with its ``from paddlebox_tpu_torch...``
    imports as a second dict, name -> (module, name)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out, imports = {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out[node.name] = _params(node, False)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for b in node.body:
                if not isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if b.name == "__init__" or (not b.name.startswith("_")
                                            and not _is_property(b)):
                    out["%s.%s" % (node.name, b.name)] = _params(b, True)
            if "%s.__init__" % node.name not in out and _is_dataclass(node):
                out["%s.__init__" % node.name] = ([
                    b.target.id for b in node.body
                    if isinstance(b, ast.AnnAssign)
                    and isinstance(b.target, ast.Name)
                    and "ClassVar" not in ast.dump(b.annotation)
                    and not (isinstance(b.value, ast.Call) and any(
                        k.arg == "init" and getattr(k.value, "value", True)
                        is False for k in b.value.keywords))], [])
        elif isinstance(node, ast.ImportFrom) and (node.module or "") \
                .startswith("paddlebox_tpu_torch"):
            for a in node.names:
                imports[a.asname or a.name] = (node.module, a.name)
    return out, imports


def port_signature(rel, key, hops=3):
    """The port's counterpart of the reference's ``key`` in module
    ``rel``: defined there, or imported there from another port module
    (followed up to ``hops`` times); None where the port has none."""
    path = os.path.join(PORT, rel)
    if not os.path.exists(path):
        return None
    sigs, imports = signatures(path)
    if key in sigs:
        return sigs[key]
    head, _, rest = key.partition(".")
    if head not in imports or not hops:
        return None
    module, name = imports[head]
    base = os.path.join(REPO, *module.split("."))
    target = (base + ".py" if os.path.exists(base + ".py")
              else os.path.join(base, "__init__.py"))
    return port_signature(os.path.relpath(target, PORT),
                          name + ("." + rest if rest else ""), hops - 1)


@pytest.mark.parametrize("rel", MODULES)
def test_every_reference_parameter_is_ported_or_declined(rel):
    """Each reference parameter of a callable the port has: a positional
    one at the reference's position in the port, a keyword-only one
    under its name; or declined with a reason."""
    ref, _ = signatures(os.path.join(REF, rel))
    missing, placed, seen = [], [], set()
    for key, (rpos, rkw) in sorted(ref.items()):
        port = port_signature(rel, key)
        if port is None:
            continue
        ppos, pkw = port
        checks = [(p, i < len(ppos) and ppos[i] == p)
                  for i, p in enumerate(rpos)]
        checks += [(p, p in ppos or p in pkw) for p in rkw]
        for p, ok in checks:
            k = "%s:%s:%s" % (rel, key, p)
            seen.add(k)
            if k in DECLINED_PARAMS:
                if ok:
                    placed.append(k)
            elif not ok:
                missing.append("%s(%s) port %s" % (key, p, ppos + pkw))
    assert not missing, ("%s: parameters with no counterpart at the "
                         "reference's position and no reason: %s"
                         % (rel, missing))
    assert not placed, "%s: declines parameters the port has: %s" % (
        rel, placed)
    stale = sorted(k for k in DECLINED_PARAMS
                   if k.split(":")[0] == rel and k not in seen)
    assert not stale, ("%s: declines parameters the reference does not "
                       "take: %s" % (rel, stale))


def test_declined_params_name_reference_modules():
    for key, reason in DECLINED_PARAMS.items():
        assert key.split(":")[0] in MODULES and reason, key


PACKAGES = sorted(rel for rel in MODULES if rel.endswith("__init__.py"))


@pytest.mark.parametrize("rel", PACKAGES)
def test_package_names_resolve(rel):
    """Every package-level name of the reference the port has resolves
    on the port's package (a lazy export loads its module)."""
    import importlib
    pkg = "paddlebox_tpu_torch" + (
        "." + os.path.dirname(rel).replace(os.sep, ".")
        if os.path.dirname(rel) else "")
    mod = importlib.import_module(pkg)
    ref = names_of(os.path.join(REF, rel), True)
    for name in sorted(ref):
        if "%s:%s" % (rel, name) in DECLINED:
            continue
        assert getattr(mod, name) is not None, (pkg, name)


def test_lazy_packages_and_serving_load_no_torch():
    code = ("import sys\n"
            "import paddlebox_tpu_torch\n"
            "import paddlebox_tpu_torch.data, paddlebox_tpu_torch.embedding\n"
            "import paddlebox_tpu_torch.train, paddlebox_tpu_torch.config\n"
            "import paddlebox_tpu_torch.metrics, paddlebox_tpu_torch.utils\n"
            "import paddlebox_tpu_torch.serving\n"
            "print(sorted(m for m in sys.modules if m == 'torch' or "
            "m.startswith('jax') or m.startswith('paddlebox_tpu.')))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


def quickstart_block():
    with open(os.path.join(REPO, "README.md")) as f:
        text = f.read()
    m = re.search(r"### Quickstart \(port\)\n.*?```python\n(.*?)```", text,
                  re.S)
    assert m, "README.md has no port Quickstart block"
    return m.group(1)


def test_readme_port_quickstart_runs_on_the_cpu(tmp_path):
    block = quickstart_block()
    assert block.count('device = "cuda"\n') == 1
    assert "paddlebox_tpu." not in block and "import jax" not in block
    script = tmp_path / "quickstart.py"
    script.write_text(block.replace('device = "cuda"\n', 'device = "cpu"\n'))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    lines = [ln for ln in r.stdout.splitlines() if "'auc'" in ln]
    assert len(lines) == 2, r.stdout
    assert "'loss'" in lines[-1]
