"""The port's multi-device planning against the JAX package's, on the CPU:
the PWS planner (``core/planner.py``), the logical-axis hints
(``core/sharding_hints.py``), the meshes (``launch/mesh.py``), the elastic
re-plan (``runtime/elastic.py``) and the dry run's plan-derived bytes and
planner options (``launch/dryrun.py``).

Every arch of ``list_archs()`` is planned at its FULL config: the port's
model built on ``meta``, JAX's through ``jax.eval_shape``, nothing
allocated; JAX's meshes are ``jax.sharding.AbstractMesh``es of the same
names and sizes as the port's ``AbstractMesh``.  Specs must be equal
entry for entry.  A port parameter is one layer's slice of JAX's stacked
leaf, so its spec is held to JAX's without the stack's leading entries.
JAX's ``plan_cache`` never reaches its KV rule for its dataclass cache
layouts (``ROADMAP.md`` queue 3), so the port's KV slabs are held to JAX's
``plan_cache`` of a dict view of the same cache (``{"k": ..., "v": ...}``:
the rule JAX meant), its state leaves to JAX's own result, and one test
pins JAX's replicated slabs.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JaxNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JaxP  # noqa: E402

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import planner as jax_planner  # noqa: E402
from repro.core import sharding_hints as jax_hints  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.runtime import elastic as jax_elastic  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, _repro_name, save_checkpoint  # noqa: E402
from repro_torch.configs import SHAPES, get_config, get_smoke_config, list_archs  # noqa: E402
from repro_torch.core import planner, sharding_hints  # noqa: E402
from repro_torch.launch import dryrun, mesh as port_mesh  # noqa: E402
from repro_torch.launch.steps import abstract_batch, build_step_bundle  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402

ARCHS = list_archs()
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((1, 1), ("data", "model"))]
_IS_P = dict(is_leaf=lambda x: isinstance(x, JaxP))


def _meshes(shape, names):
    return port_mesh.AbstractMesh(shape, names), JaxAbstractMesh(shape, names)


def _flat(tree):
    """JAX tree -> {'/'-joined key path: leaf} (specs kept whole)."""
    return {jax.tree_util.keystr(p, simple=True, separator="/"): leaf
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree, **_IS_P)}


def _keyed(tree):
    """JAX tree -> {keystr path: leaf}, the paths ``planner.tree_items`` writes."""
    return {jax.tree_util.keystr(p): leaf
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree, **_IS_P)}


def _dict_view(tree):
    """A cache tree with each dataclass layout as a dict of its array
    fields (``b_axis`` is static, not a leaf)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _dict_view(getattr(tree, f.name)) for f in dataclasses.fields(tree)
                if not isinstance(getattr(tree, f.name), int)}
    if isinstance(tree, dict):
        return {k: _dict_view(v) for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def full():
    """Per arch at its full config: the port's model on ``meta`` (its
    parameters, AdamW state) and JAX's abstract params and AdamW state."""
    out = {}
    for arch in ARCHS:
        jm = jax_build(jax_get_config(arch))
        ap = jax.eval_shape(lambda jm=jm: jm.init(jax.random.key(0)))
        model = build_model(get_config(arch), device="meta")
        params = dict(model.named_parameters())
        out[arch] = dict(jm=jm, ap=ap, aopt=jax.eval_shape(jax_adamw_init, ap), model=model,
                         params=params, opt=adamw_init(params))
    return out


def _assert_param_specs(port_specs, jax_specs, prefix=""):
    jflat = _flat(jax_specs)
    for name, spec in port_specs.items():
        jname, layer = _repro_name(prefix + name)
        want = tuple(jflat[jname])[len(layer or ()):]
        assert tuple(spec) == want, (name, spec, jflat[jname])
    assert {_repro_name(prefix + n)[0] for n in port_specs} == set(jflat)


# -- parameters and the AdamW state -----------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_plans_match_jax(full, arch):
    """Every parameter's spec, on four meshes in both modes, and the AdamW
    state's (step replicated, master / m / v as fsdp params), equal JAX's."""
    f = full[arch]
    for shape, names in MESHES:
        pm, jm = _meshes(shape, names)
        for mode in ("fsdp", "zero1"):
            _assert_param_specs(planner.plan_params(f["params"], pm, mode=mode),
                                jax_planner.plan_params(f["ap"], jm, mode=mode))
        ospec = planner.plan_opt_state(f["opt"], pm)
        assert ospec["step"] == planner.P() == tuple(JaxP())
        for key in ("master", "m", "v"):
            _assert_param_specs(ospec[key], jax_planner.plan_params(f["aopt"][key], jm))


# -- batches ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_batch_plans_match_jax(full, arch):
    """``plan_batch`` of the three step kinds' batches (with each family's
    modality inputs) at every shape of ``SHAPES``, on four meshes."""
    f = full[arch]
    for shape_name, shape in SHAPES.items():
        jshape = JAX_SHAPES[shape_name]
        cases = [(abstract_batch(f["model"], shape, with_labels=True),
                  jax_steps.abstract_batch(f["jm"], jshape, with_labels=True)),
                 (abstract_batch(f["model"], shape, with_labels=False),
                  jax_steps.abstract_batch(f["jm"], jshape, with_labels=False)),
                 ({"tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                         device="meta")},
                  {"tokens": jax.ShapeDtypeStruct((shape.global_batch, 1), jnp.int32)})]
        for shape_mesh, names in MESHES:
            pm, jm = _meshes(shape_mesh, names)
            for pb, jb in cases:
                assert {k: tuple(v.shape) for k, v in pb.items()} == \
                    {k: tuple(v.shape) for k, v in jb.items()}
                got = planner.plan_batch(pb, pm)
                want = jax_planner.plan_batch(jb, jm)
                assert {k: tuple(v) for k, v in got.items()} == \
                    {k: tuple(v) for k, v in want.items()}, (shape_name, shape_mesh)


# -- caches -------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cache_plans_match_jax(full, arch):
    """State leaves equal JAX's ``plan_cache`` (``tail_*`` replicated as
    JAX leaves them); KV slabs equal JAX's ``plan_cache`` of the dict view
    (b over dp, kv heads or else S over tp, the b == 1 long-context rule);
    the cache's leaves have JAX's shapes."""
    f = full[arch]
    for b, s in ((128, 32768), (1, 524288), (8, 4096)):
        jcache = jax.eval_shape(lambda: f["jm"].init_cache(b, s))
        pcache = f["model"].init_cache(b, s)
        shapes = {p: tuple(t.shape) for p, t in planner.tree_items(pcache)}
        assert shapes == {p: tuple(x.shape) for p, x in _keyed(jcache).items()}
        for shape_mesh, names in MESHES[:3]:
            pm, jm = _meshes(shape_mesh, names)
            own = _keyed(jax_planner.plan_cache(jcache, jm))
            meant = _flat(jax_planner.plan_cache(_dict_view(jcache), jm))
            for path, spec in planner.tree_items(planner.plan_cache(pcache, pm)):
                field = path.rsplit(".", 1)[-1]
                if field in ("k", "v"):
                    key = path.replace("['", "").replace("']", "/").replace(".", "/")
                    key = "/".join(p for p in key.split("/") if p)
                    want = meant[key]
                else:
                    want = own[path]
                assert tuple(spec) == tuple(want), (arch, b, s, shape_mesh, path)


def test_jax_replicates_dataclass_kv_slabs(full):
    """The fault in the reference that the port does not copy: JAX's
    ``plan_cache`` reads only dict keys, so the KV slabs of its dataclass
    layouts match no rule and come out replicated; the port shards them."""
    pm, jm = _meshes((16, 16), ("data", "model"))
    # qwen3-1.7b's and the hybrid's kv heads (8, 1) do not divide 16: S over tp
    cases = {"qwen3-1.7b": (".k", (None, "data", "model", None, None)),
             "recurrentgemma-2b": ("['kv'].k", (None, "data", "model", None, None)),
             "seamless-m4t-large-v2": ("['cross'].k", (None, "data", None, "model", None))}
    for arch, (path, port_want) in cases.items():
        jcache = jax.eval_shape(lambda: full[arch]["jm"].init_cache(128, 32768))
        jspec = _keyed(jax_planner.plan_cache(jcache, jm))[path]
        assert tuple(jspec) == (None,) * len(port_want)
        got = dict(planner.tree_items(planner.plan_cache(
            full[arch]["model"].init_cache(128, 32768), pm)))[path]
        assert tuple(got) == port_want


# -- the logical-axis hints ---------------------------------------------------------

HINT_CASES = [
    ((256, 4096, 2048), ("batch", "seq", None)),
    ((3, 4096, 2048), ("batch", "seq", "*")),
    ((256, 1, 32, 128), ("batch", None, "heads", None)),
    ((256, 1, 8, 128), ("batch", None, "kv_heads", None)),
    ((256, 4096, 6144), ("batch", "*", "ffn")),
    ((256, 4096, 151936), ("batch", None, "vocab")),
    ((128, 40, 2048), ("experts", None, None)),
    ((7, 5), ("batch", "ffn")),
    ((16, 16), ("unknown", None)),
    ((32, 48), (None, None)),
]


@pytest.mark.parametrize("shape_mesh, names", MESHES)
def test_hints_resolve_as_jax_constrains(shape_mesh, names):
    """``sharding_hints.resolve`` equals the spec JAX's ``constrain`` hands
    ``with_sharding_constraint`` (captured by patching it), on divisible and
    non-divisible dims; where JAX applies none, the port resolves None."""
    pm, jm = _meshes(shape_mesh, names)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "with_sharding_constraint",
                   lambda x, spec: seen.append(spec) or x)
        for shape, axes in HINT_CASES:
            seen.clear()
            with jax_hints.axis_rules(jax_hints.default_rules(jm), jm):
                jax_hints.constrain(jax.ShapeDtypeStruct(shape, jnp.float32), *axes)
            with sharding_hints.axis_rules(sharding_hints.default_rules(pm), pm):
                got = sharding_hints.resolve(shape, *axes)
            if not seen:
                assert got is None, (shape, axes, got)
                continue
            want = tuple(sharding_hints.UNCONSTRAINED if e is JaxP.UNCONSTRAINED else e
                         for e in seen[0])
            assert got is not None and tuple(got) == want, (shape, axes, got, seen[0])


def test_constrain_on_one_device_returns_its_input():
    mesh = port_mesh.make_debug_mesh(device="cpu")
    x = torch.zeros(4, 8)
    with sharding_hints.axis_rules(sharding_hints.default_rules(mesh), mesh):
        assert sharding_hints.constrain(x, "batch", "ffn") is x
        assert sharding_hints.constrain(x, None, "*") is x
    assert sharding_hints.constrain(x, "batch", None) is x  # no binding


# -- meshes -------------------------------------------------------------------------

def _two_by_two():
    """A real DeviceMesh of four devices, built without a process group."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"),
                      _init_backend=False)


def test_meshes():
    m = port_mesh.make_debug_mesh(device="cpu")
    assert port_mesh.axis_sizes(m) == {"data": 1, "model": 1}
    assert port_mesh.mesh_device(m) == torch.device("cpu")
    assert port_mesh.make_debug_mesh(1, tp=1, device="cpu") is m
    for multi, want in ((False, {"data": 16, "model": 16}),
                        (True, {"pod": 2, "data": 16, "model": 16})):
        pm = port_mesh.make_production_mesh(multi_pod=multi)
        assert port_mesh.axis_sizes(pm) == want == dict(JaxAbstractMesh(
            tuple(want.values()), tuple(want)).shape)
        assert port_mesh.mesh_device_count(pm) == (512 if multi else 256)
        with pytest.raises(TypeError, match="no devices"):
            port_mesh.mesh_device(pm)
    assert port_mesh.mesh_device_count(_two_by_two()) == 4
    with pytest.raises(ValueError, match="holds 1"):
        port_mesh.make_debug_mesh(4, device="cpu")


def test_a_mesh_of_more_than_one_device_raises(tmp_path):
    """Every entry point given a real mesh of four devices that this
    process's group (world size 1) does not hold raises ``ValueError``; a
    ``constrain`` under that mesh's binding holds a tensor's local shape to
    the spec its bound extents give; nothing is replicated quietly.  (The
    sharded runs themselves, over four gloo ranks, are
    ``tests/test_torch_sharded.py``'s.)"""
    from repro_torch.data import DataConfig
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.serve import Server
    from repro_torch.launch.train import train

    mesh = _two_by_two()
    cfg = get_smoke_config("qwen3-1.7b")
    like = build_model(cfg, device="meta").state_dict()
    save_checkpoint(tmp_path, 0, {"params": build_model(cfg, device="cpu").state_dict()})
    calls = [
        lambda: Server(cfg, mesh=mesh),
        lambda: Engine(cfg, mesh=mesh),
        lambda: Engine.restart(cfg, tmp_path, mesh=mesh),
        lambda: train(cfg, steps=1, data_cfg=DataConfig(global_batch=2, seq_len=8), mesh=mesh),
        lambda: elastic.serving_restore(CheckpointManager(tmp_path), like, mesh),
        lambda: planner.place({"x": torch.zeros(4)}, {"x": planner.P("data")}, mesh),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="not one of its ranks"):
            call()
    extents = {"batch": 4, "ffn": 8}
    with sharding_hints.axis_rules(sharding_hints.default_rules(mesh), mesh, extents):
        with pytest.raises(ValueError, match="holds 4 of 4"):
            sharding_hints.constrain(torch.zeros(4, 8), "batch", "ffn")
        block = torch.zeros(2, 4)
        assert sharding_hints.constrain(block, "batch", "ffn") is block
        meta = torch.empty(4, 8, device="meta")
        assert sharding_hints.constrain(meta, "batch", "ffn") is meta


def test_named_gives_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _two_by_two()
    specs = planner.named({"a": planner.P("data", "model"), "b": planner.P(None, "data"),
                           "c": planner.P(("data", "model"), None), "d": planner.P()}, mesh)
    assert specs["a"].placements == (Shard(0), Shard(1))
    assert specs["b"].placements == (Shard(1), Replicate())
    assert specs["c"].placements == (Shard(0), Shard(0))
    assert specs["d"].placements == (Replicate(), Replicate())


def test_tall_cache_uses_the_h100():
    assert planner.SMEM_BYTES == 227 * 1024 and planner.LINE_BYTES == 128
    assert planner.tall_cache_ok() and not planner.tall_cache_ok(block_bytes=1 << 20)


# -- the elastic re-plan ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen3-moe-30b-a3b", "llama-3.2-vision-90b"])
def test_replan_for_mesh_matches_jax(full, arch):
    f = full[arch]
    for shape, names in MESHES[:2]:
        pm, jm = _meshes(shape, names)
        got = elastic.replan_for_mesh({"params": f["params"], "opt_state": f["opt"]}, pm)
        want = jax_elastic.replan_for_mesh({"params": f["ap"], "opt_state": f["aopt"]}, jm)
        def spec(t):
            return {k: spec(v) for k, v in t.items()} if isinstance(t, dict) else t.spec


        jspec = lambda t: jax.tree.map(lambda s: s.spec, t)  # noqa: E731
        _assert_param_specs(spec(got["params"]), jspec(want["params"]))
        for key in ("master", "m", "v"):
            _assert_param_specs(spec(got["opt_state"][key]), jspec(want["opt_state"][key]))
        assert tuple(got["opt_state"]["step"].spec) == tuple(want["opt_state"]["step"].spec)
        params_only = elastic.replan_params_for_mesh(f["params"], pm)
        _assert_param_specs(spec(params_only),
                            jspec(jax_elastic.replan_params_for_mesh(f["ap"], jm)))


def test_elastic_restore_onto_a_one_device_mesh_is_bit_equal(tmp_path):
    """A train state (bf16 params, f32 AdamW state) and a params checkpoint
    come back bit for bit, on the mesh's device, into fresh tensors."""
    cfg = get_smoke_config("qwen3-1.7b")
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(3))
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    for leaf in opt["m"].values():
        leaf.normal_(generator=torch.Generator().manual_seed(4))
    opt["step"].fill_(7)
    save_checkpoint(tmp_path, 5, {"params": params, "opt_state": opt},
                    mesh_shape={"data": 1, "model": 1})
    mesh = port_mesh.make_debug_mesh(device="cpu")
    like = {"params": build_model(cfg, device="meta").state_dict(),
            "opt_state": adamw_init(build_model(cfg, device="meta").state_dict())}
    step, state = elastic.elastic_restore(CheckpointManager(tmp_path), like, mesh)
    assert step == 5 and int(state["opt_state"]["step"]) == 7
    for name, p in params.items():
        got = state["params"][name]
        assert got.device.type == "cpu" and got.dtype == p.dtype
        assert torch.equal(got.view(torch.int16), p.detach().view(torch.int16)), name
        for key in ("master", "m", "v"):
            assert torch.equal(state["opt_state"][key][name], opt[key][name]), (key, name)
    step, served = elastic.serving_restore(CheckpointManager(tmp_path), like["params"], mesh)
    assert step == 5 and all(torch.equal(served[n], params[n].detach()) for n in params)


# -- the dry run ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_dryrun():
    """JAX's dry-run module, imported with ``XLA_FLAGS`` restored after (its
    first lines set a 512-device host platform for its own process)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
        from repro.launch import dryrun as jd
    return jd


def test_planner_defaults_match_jax_in_every_cell(jax_dryrun):
    cells = dryrun.all_cells(["single", "multi"])
    assert cells == jax_dryrun.all_cells(["single", "multi"]) and len(cells) == 80
    for arch, shape, mesh_kind in cells:
        pm = port_mesh.make_production_mesh(multi_pod=mesh_kind == "multi")
        names = port_mesh.axis_names(pm)
        jm = JaxAbstractMesh(tuple(port_mesh.axis_sizes(pm).values()), names)
        assert dryrun.planner_defaults(get_config(arch), SHAPES[shape], pm) == \
            jax_dryrun.planner_defaults(jax_get_config(arch), JAX_SHAPES[shape], jm)


def _jax_bytes(tree, specs, mesh) -> int:
    total = 0
    for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(specs, **_IS_P)):
        shard = JaxNamedSharding(mesh, spec).shard_shape(leaf.shape)
        total += int(np.prod(shard, dtype=np.int64)) * jnp.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_match_jax_in_every_cell(full, arch):
    """``memory.argument_bytes`` of each of the arch's cells on both
    production meshes equals the bytes of JAX's plan over JAX's
    ``eval_shape``d step inputs (the KV slabs by the rule JAX meant), with no
    compile."""
    f = full[arch]
    cfg = get_config(arch)
    for shape_name, shape in SHAPES.items():
        if shape_name == "long_500k" and not cfg.supports_long_context:
            continue
        jshape = JAX_SHAPES[shape_name]
        bundle = build_step_bundle(cfg, shape, model=f["model"])
        for mesh_kind in ("single", "multi"):
            pm = port_mesh.make_production_mesh(multi_pod=mesh_kind == "multi")
            jm = JaxAbstractMesh(tuple(port_mesh.axis_sizes(pm).values()),
                                 port_mesh.axis_names(pm))
            want = _jax_bytes(f["ap"], jax_planner.plan_params(f["ap"], jm), jm)
            if shape.kind == "train":
                jb = jax_steps.abstract_batch(f["jm"], jshape, with_labels=True)
                want += _jax_bytes(f["aopt"], {
                    "step": JaxP(), **{k: jax_planner.plan_params(f["aopt"][k], jm)
                                       for k in ("master", "m", "v")}}, jm)
                want += _jax_bytes(jb, jax_planner.plan_batch(jb, jm), jm)
            elif shape.kind == "prefill":
                jb = jax_steps.abstract_batch(f["jm"], jshape, with_labels=False)
                want += _jax_bytes(jb, jax_planner.plan_batch(jb, jm), jm)
            else:
                tok = {"t": jax.ShapeDtypeStruct((jshape.global_batch, 1), jnp.int32)}
                view = _dict_view(jax_steps.abstract_cache(f["jm"], jshape))
                want += _jax_bytes(tok, jax_planner.plan_batch(tok, jm), jm) + 4
                want += _jax_bytes(view, jax_planner.plan_cache(view, jm), jm)
            got = dryrun.plan_bytes(bundle, shape, pm)["argument_bytes"]
            assert got == want, (arch, shape_name, mesh_kind, got, want)


def test_dry_run_traces_a_smoke_cell():
    """One traced cell at the smoke config (host only, ``meta``): JAX's
    record keys, bytes that add up, the trace's FLOPs."""
    cfg = get_smoke_config("qwen3-1.7b")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=32)
    rec = dryrun.run_cell("qwen3-1.7b", "train_4k", "single", cfg=cfg, shape=shape)
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    mem = rec["memory"]
    assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "peak_bytes_est"} <= set(mem)
    assert mem["peak_bytes_est"] == (mem["argument_bytes"] + mem["output_bytes"]
                                     + mem["temp_bytes"] - mem["alias_bytes"])
    assert mem["temp_bytes"] > 0 and mem["alias_bytes"] > 0
    assert set(rec["hlo"]) == {"flops", "hbm_bytes", "collective_bytes", "collectives",
                               "n_while", "unknown_trip_counts"}
    assert rec["hlo"]["flops"] > 0 and rec["hlo"]["collective_bytes"] == 0
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant"}
    assert rec["trace"]["per_device_batch"] == 2
    skip = dryrun.run_cell("qwen3-1.7b", "long_500k", "multi")
    assert skip["status"] == "SKIP(full-attention)"
