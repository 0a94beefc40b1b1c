"""The port's epoch transition against the JAX package's, on numpy-seeded
MINIMAL states of 64 validators (built directly, not with StateHarness).

  * the plain k_sums / k_state against the JAX kernels (jitted under
    jax.enable_x64), exactly, on chip_smoke's edge lanes and random lanes;
  * the port's process_epoch on its engine ("cuda" backend, device "cpu":
    the kernels' plain versions, threshold 1) and on its scalar path
    against the JAX scalar process_epoch: equal SSZ bytes, and the engine
    state's root (through the root plane) equal to the JAX root;
  * the routing gates, a kernel fault, the root plane and RegistryList;
  * the envelope probe: a lane the JAX kernel wraps where its scalar rule
    does not, and the port following the JAX kernel.

States cross as SSZ bytes.  The tolerance is exact equality.  The JAX
package's own device path cannot run here (its kernels.py imports
jax.experimental.enable_x64, which this JAX no longer has), so its
kernels are jitted directly and its scalar process_epoch is the oracle.
"""
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu import types as jty
from lighthouse_tpu.crypto.sha256 import api as jhash
from lighthouse_tpu.state_transition import helpers as jhelpers
from lighthouse_tpu.state_transition import per_epoch as jpe
from lighthouse_tpu.state_transition.epoch_engine import api as japi
from lighthouse_tpu.state_transition.epoch_engine import kernels as jk
from lighthouse_tpu.state_transition.epoch_engine import soa as jsoa
from lighthouse_tpu_torch import types as ty
from lighthouse_tpu_torch.crypto.bls import SecretKey
from lighthouse_tpu_torch.crypto.sha256 import api as hapi
from lighthouse_tpu_torch.state_transition import helpers, per_epoch
from lighthouse_tpu_torch.state_transition.epoch_engine import api, soa
from lighthouse_tpu_torch.state_transition.epoch_engine.cuda import kernel

from chip_smoke import epoch_edge_lanes

GWEI = 10 ** 9
FAR = 2 ** 64 - 1
N = 64
E = ty.MINIMAL
CPU = torch.device("cpu")
# Four real keys, repeated: a sync committee must aggregate its pubkeys.
KEYS = [SecretKey(k).public_key().to_bytes() for k in (1, 2, 3, 4)]
SPECS = {"altair": replace(ty.ChainSpec.minimal(), altair_fork_epoch=0),
         "deneb": replace(ty.ChainSpec.minimal(), deneb_fork_epoch=0)}


@pytest.fixture(autouse=True)
def _engines():
    api.reset_engine()
    hapi.reset_engine()
    hapi.configure(backend="cuda", threshold=8, device="cpu")
    japi.reset_engine()
    japi.configure(backend="python")
    jhash.reset_engine()
    jhash.configure(backend="hashlib")
    yield
    api.reset_engine()
    hapi.reset_engine()
    japi.reset_engine()
    jhash.reset_engine()


# --- The kernels against the JAX kernels -------------------------------------


def _jax_kernels(planes, scal):
    with jax.enable_x64(True):
        sums = jax.jit(jk.k_sums)(
            planes["eff"], planes["act"], planes["exitp"],
            planes["slashed"].astype(bool), planes["pflags"],
            planes["cflags"], np.asarray(scal[:2], np.uint64))
        state = jax.jit(jk.k_state)(
            planes["eff"], planes["bal"], planes["slashed"].astype(bool),
            planes["act"], planes["exitp"], planes["wd"], planes["scores"],
            planes["pflags"], np.asarray(scal, np.uint64))
        return np.asarray(sums), [np.asarray(x) for x in state]


def _port_kernels(planes, scal):
    t = {k: kernel.plane(v, CPU) for k, v in planes.items()}
    sums = kernel.k_sums(t["eff"], t["act"], t["exitp"], t["slashed"],
                         t["pflags"], t["cflags"],
                         kernel.scalar_tensor(scal[:2]))
    state = kernel.k_state(t["eff"], t["bal"], t["slashed"], t["act"],
                           t["exitp"], t["wd"], t["scores"], t["pflags"],
                           kernel.scalar_tensor(scal))
    return (sums.numpy().view(np.uint64),
            [x.numpy().view(np.uint64) for x in state])


def _random_lanes(rng, n):
    """Random lanes with FAR_FUTURE_EPOCH epochs, balances up to 2^61 and
    products that wrap past 2^63."""
    far = np.uint64(FAR)
    u64 = lambda lo, hi: rng.integers(lo, hi, n, dtype=np.uint64)
    pick = lambda p, a, b: np.where(rng.random(n) < p, a, b).astype(np.uint64)
    return {
        "eff": pick(0.1, u64(1 << 39, 1 << 40), u64(0, 33) * np.uint64(GWEI)),
        "bal": pick(0.1, u64(1 << 60, 1 << 61), u64(0, 40 * GWEI)),
        "slashed": (rng.random(n) < 0.2).astype(np.uint8),
        "act": pick(0.2, far, u64(90, 105)),
        "exitp": pick(0.5, far, u64(95, 110)),
        "wd": pick(0.3, far, u64(95, 140)),
        "scores": pick(0.1, u64(1 << 25, 1 << 26), u64(0, 60)),
        "pflags": rng.integers(0, 8, n, dtype=np.uint8),
        "cflags": rng.integers(0, 8, n, dtype=np.uint8),
    }


def _random_scalars(rng, leak):
    s = [int(x) for x in rng.integers(1, 1 << 30, 18)]
    s[0], s[1], s[2] = 100, 101, leak
    s[8], s[9], s[13] = 4, 16, GWEI
    s[14], s[15], s[16], s[17] = 32 * GWEI, GWEI // 4, GWEI // 4 * 5, 120
    return s


@pytest.mark.parametrize("lanes", ["edge", "random"])
def test_plain_kernels_equal_the_jax_kernels(lanes):
    if lanes == "edge":
        planes, scalar_sets = epoch_edge_lanes()
    else:
        rng = np.random.default_rng(0xE90C)
        planes = _random_lanes(rng, 97)
        scalar_sets = [_random_scalars(rng, leak) for leak in (0, 1)]
    for scal in scalar_sets:
        want_sums, want_state = _jax_kernels(planes, scal)
        got_sums, got_state = _port_kernels(planes, scal)
        assert np.array_equal(got_sums, want_sums)
        for got, want in zip(got_state, want_state):
            assert np.array_equal(got, want)


def test_kernel_wrappers_check_arguments_and_count_no_cpu_launch():
    z = torch.zeros(4, dtype=torch.int64)
    b = torch.zeros(4, dtype=torch.uint8)
    two = kernel.scalar_tensor((1, 2))
    with pytest.raises(ValueError, match="k_sums slashed: dtype"):
        kernel.k_sums(z, z, z, b.bool(), b, b, two)
    with pytest.raises(ValueError, match="k_sums act: shape"):
        kernel.k_sums(z, z[:3], z, b, b, b, two)
    with pytest.raises(ValueError, match="k_sums scal: shape"):
        kernel.k_sums(z, z, z, b, b, b, kernel.scalar_tensor((1,)))
    with pytest.raises(ValueError, match="k_state scal: on meta"):
        kernel.k_state(z, z, b, z, z, z, z, b, two.to("meta"))
    with pytest.raises(ValueError, match="k_state wd: not contiguous"):
        kernel.k_state(z, z, b, z, z, torch.zeros(4, 2, dtype=torch.int64)
                       [:, 0], z, b, torch.zeros(18, dtype=torch.int64))
    assert kernel.k_sums(z, z, z, b, b, b, two).tolist() == [0] * 6
    assert kernel.launch_counts() == {"k_sums": 0, "k_state": 0}


def test_uint64_division_of_the_plain_versions():
    rng = np.random.default_rng(0xD1F)
    xs = [0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1, 2 ** 64 - 2]
    xs += [int(v) for v in rng.integers(0, 2 ** 63, 20, dtype=np.int64)]
    xs += [2 ** 63 + int(v) for v in rng.integers(0, 2 ** 63, 20,
                                                  dtype=np.int64)]
    t = torch.tensor([kernel.as_i64(x) for x in xs], dtype=torch.int64)
    for d in (1, 3, 64, GWEI, 2 ** 26, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1):
        q = [kernel.as_u64(v) for v in kernel._div(t, d).tolist()]
        r = [kernel.as_u64(v) for v in kernel._mod(t, d).tolist()]
        assert q == [x // d for x in xs] and r == [x % d for x in xs]


# --- States ------------------------------------------------------------------


def _jax_state(seed, fork, epoch, finalized, n=N):
    """A MINIMAL state of the JAX package: 32 ETH effective balances,
    random balances, participation and inactivity scores (as the JAX
    suite's _randomize), random block roots and mixes."""
    rng = np.random.default_rng(seed)
    jT = jty.SpecTypes(jty.MINIMAL)
    roots = lambda k: [bytes(rng.integers(0, 256, 32, dtype=np.uint8))
                       for _ in range(k)]
    vals = [jty.Validator(
        pubkey=KEYS[i % len(KEYS)], withdrawal_credentials=roots(1)[0],
        effective_balance=32 * GWEI, activation_eligibility_epoch=0,
        activation_epoch=0, exit_epoch=FAR, withdrawable_epoch=FAR)
        for i in range(n)]
    committee = [KEYS[i % len(KEYS)] for i in range(E.sync_committee_size)]
    cp = lambda e: jty.Checkpoint(epoch=e, root=roots(1)[0])
    fields = dict(
        genesis_time=1_600_000_000, slot=(epoch + 1) * E.slots_per_epoch - 1,
        genesis_validators_root=roots(1)[0],
        block_roots=roots(E.slots_per_historical_root),
        state_roots=roots(E.slots_per_historical_root),
        randao_mixes=roots(E.epochs_per_historical_vector),
        validators=vals,
        balances=[int(x) for x in rng.integers(15 * GWEI, 40 * GWEI, n)],
        previous_epoch_participation=rng.integers(0, 8, n).tolist(),
        current_epoch_participation=rng.integers(0, 8, n).tolist(),
        inactivity_scores=rng.integers(0, 50, n).tolist(),
        justification_bits=[True, True, False, False],
        previous_justified_checkpoint=cp(finalized),
        current_justified_checkpoint=cp(finalized + 1),
        finalized_checkpoint=cp(finalized),
        current_sync_committee=jT.SyncCommittee(pubkeys=committee,
                                                aggregate_pubkey=KEYS[0]),
        next_sync_committee=jT.SyncCommittee(pubkeys=committee[::-1],
                                             aggregate_pubkey=KEYS[1]))
    return jT.states[fork](**fields)


def _port(jstate):
    """The JAX state carried across as SSZ bytes."""
    raw = type(jstate).encode(jstate)
    state = ty.state_from_ssz_bytes(raw, ty.SpecTypes(E), E,
                                    SPECS[jstate.fork_name])
    assert type(state).encode(state) == raw
    return state


def _process(state, backend):
    api.configure(backend=backend, threshold=1, device="cpu")
    per_epoch.process_epoch(state, ty.SpecTypes(E), E,
                            SPECS[state.fork_name])


def _jax_process(jstate):
    jpe.process_epoch(jstate, jty.SpecTypes(jty.MINIMAL), jty.MINIMAL,
                      jty.ChainSpec.minimal())


def _assert_same(jstate, *states):
    want = type(jstate).encode(jstate)
    for state in states:
        assert type(state).encode(state) == want


def _run_three(jstate):
    """JAX scalar, port scalar and port engine on the same epoch."""
    scalar, engine = _port(jstate), _port(jstate)
    _process(scalar, "python")
    status = api.engine_status()
    assert status["last_scalar_ms"] > 0
    answered = status["answered"]
    _process(engine, "cuda")
    assert api.engine_status()["answered"]["cuda"] == answered["cuda"] + 1
    _jax_process(jstate)
    _assert_same(jstate, scalar, engine)
    assert isinstance(engine.validators, soa.RegistryList)
    digests = hapi.engine_status()["digests"]["cuda"]
    assert type(engine).hash_tree_root(engine) == \
        type(jstate).hash_tree_root(jstate)
    assert engine.validators._roots is not None      # the plane was used
    assert hapi.engine_status()["digests"]["cuda"] > digests
    return scalar, engine


def _slashing_sweep(st, cur):
    v = st.validators[3]
    v.slashed = True
    v.withdrawable_epoch = cur + E.epochs_per_slashings_vector // 2
    st.slashings[0] = 3 * GWEI


def _exiting(st, cur):
    st.validators[5].exit_epoch = cur + 3
    st.validators[5].withdrawable_epoch = cur + 3 + 256


def _pending_activation(st, cur):
    for i in (7, 11, 13):
        st.validators[i].activation_eligibility_epoch = 0
        st.validators[i].activation_epoch = FAR


def _ejection(st, cur):
    for i in (9, 21):
        st.validators[i].effective_balance = 15 * GWEI


def _hysteresis_boundary(st, cur):
    for i, delta in ((2, -GWEI // 4), (4, -GWEI // 4 - 1),
                     (6, GWEI // 4 * 5 + 1)):
        st.validators[i].effective_balance = 31 * GWEI
        st.balances[i] = 31 * GWEI + delta


SCENARIOS = {  # name: (plant, fork, epoch, finalized)
    "slashing_sweep": (_slashing_sweep, "altair", 4, 2),
    "exiting": (_exiting, "deneb", 4, 2),
    "pending_activation": (_pending_activation, "altair", 4, 2),
    "ejection": (_ejection, "deneb", 4, 2),
    "hysteresis_boundary": (_hysteresis_boundary, "altair", 4, 2),
    "leak_epoch": (_slashing_sweep, "deneb", 9, 2),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_process_epoch_matches_the_jax_scalar_path(name):
    plant, fork, epoch, finalized = SCENARIOS[name]
    jstate = _jax_state(sum(name.encode()), fork, epoch, finalized)
    plant(jstate, epoch)
    _run_three(jstate)


def test_sync_committee_boundary_matches_the_jax_scalar_path():
    # MINIMAL rotates every 8 epochs: the epoch ending at cur = 7 samples
    # the next committee (and appends a historical root).
    cur = E.epochs_per_sync_committee_period - 1
    jstate = _jax_state(32, "altair", cur, cur - 2)
    before = bytes(jstate.next_sync_committee.aggregate_pubkey)
    scalar, engine = _run_three(jstate)
    assert engine.next_sync_committee == scalar.next_sync_committee
    assert bytes(engine.next_sync_committee.aggregate_pubkey) != before
    assert [r["stage"] for r in api.last_stage_rows()] == [
        "snapshot", "sums", "justification", "registry", "kernel",
        "writeback", "sync_committee"]


def test_three_epoch_walk_with_a_slashing_matches_the_jax_scalar_path():
    jstate = _jax_state(33, "deneb", 3, 1)
    engine = _port(jstate)
    jT = jty.SpecTypes(jty.MINIMAL)
    rng = np.random.default_rng(34)
    for step in range(3):
        if step == 1:
            helpers.slash_validator(engine, 12, E, SPECS["deneb"])
            jhelpers.slash_validator(jstate, 12, jty.MINIMAL,
                                     jty.ChainSpec.minimal())
        _process(engine, "cuda")
        _jax_process(jstate)
        _assert_same(jstate, engine)
        assert type(engine).hash_tree_root(engine) == \
            jT.states["deneb"].hash_tree_root(jstate), f"step {step}"
        flags = rng.integers(0, 8, N).tolist()
        for st in (engine, jstate):
            st.current_epoch_participation = list(flags)
            st.slot += E.slots_per_epoch
    assert api.engine_status()["answered"]["cuda"] == 3


# --- Routing, faults, the root plane -----------------------------------------


@pytest.fixture
def no_kernels(monkeypatch):
    def launched(*a, **k):
        raise AssertionError("a kernel ran")

    monkeypatch.setattr(kernel, "run_sums", launched)
    monkeypatch.setattr(kernel, "run_state", launched)


@pytest.mark.parametrize("gate", [
    "python_backend", "under_threshold", "genesis_edge", "max_balance",
    "max_score", "max_effective", "base_fork"])
def test_routing_gates_go_to_the_scalar_path(gate, no_kernels):
    jstate = _jax_state(40, "altair", 1 if gate == "genesis_edge" else 4, 0)
    state = _port(jstate)
    if gate == "base_fork":
        state = ty.SpecTypes(E).states["base"](slot=4 * E.slots_per_epoch,
                                               validators=state.validators)
    if gate == "max_balance":
        state.balances[0] = api.MAX_BALANCE + 1
    if gate == "max_score":
        state.inactivity_scores[0] = api.MAX_INACTIVITY_SCORE + 1
    if gate == "max_effective":
        state.validators[0].effective_balance = api.MAX_EFFECTIVE + 1
    api.configure(backend="python" if gate == "python_backend" else "cuda",
                  threshold=N + 1 if gate == "under_threshold" else 1,
                  device="cpu")
    before = type(state).encode(state)
    assert not api.try_process_epoch(state, ty.SpecTypes(E), E,
                                     SPECS["altair"])
    assert type(state).encode(state) == before
    status = api.engine_status()
    assert status["answered"]["cuda"] == 0 and status["faults"] == 0


def test_a_cuda_epoch_without_a_card_raises(monkeypatch, no_kernels):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = _port(_jax_state(41, "altair", 4, 2))
    before = type(state).encode(state)
    api.configure(threshold=1)                    # device: the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        per_epoch.process_epoch(state, ty.SpecTypes(E), E, SPECS["altair"])
    assert type(state).encode(state) == before


def test_a_kernel_fault_restores_justification_and_raises(monkeypatch):
    def fault(*a, **k):
        raise RuntimeError("injected kernel fault")

    monkeypatch.setattr(kernel, "run_state", fault)
    state = _port(_jax_state(42, "altair", 4, 2))
    before = type(state).encode(state)
    with pytest.raises(RuntimeError, match="injected kernel fault"):
        _process(state, "cuda")
    assert type(state).encode(state) == before
    status = api.engine_status()
    assert status["faults"] == 1 and "injected" in status["last_fault"]
    assert status["answered"] == {"cuda": 0, "python": 0}


def test_envelope_probe_the_port_follows_the_jax_kernel():
    """eff 2^40 and score 2^26 are inside the engine's envelope (strict >
    guards), but eff * new_score wraps in the kernel: the JAX scalar rule
    takes the lane's balance to 0, the JAX kernel (and so the port's
    engine) charges 2^16 gwei.  Recorded in ROADMAP Queue 3; not fixed."""
    jstate = _jax_state(43, "deneb", 9, 2)       # leak: no recovery
    v = jstate.validators[7]
    v.effective_balance = 1 << 40
    jstate.inactivity_scores[7] = 1 << 26
    jstate.previous_epoch_participation[7] = 0b101   # out of target
    jstate.balances[7] = 32 * GWEI
    engine = _port(jstate)
    pre = soa.RegistrySoA.snapshot(engine)
    _process(engine, "cuda")
    assert api.engine_status()["answered"]["cuda"] == 1
    _jax_process(jstate)
    assert jstate.balances[7] == 0                         # exact rule
    wrapped = engine.balances[7]
    assert 31 * GWEI < wrapped < 32 * GWEI                 # 2^16 charged
    exact = (1 << 40) * ((1 << 26) + 4) // (4 * 2 ** 24)
    assert exact == 1_099_511_693_312
    # The JAX kernel gives the port's balance on the same inputs.
    spec = SPECS["deneb"]
    sums = kernel.run_sums(pre, 8, 9, CPU)
    total = max(GWEI, int(sums[0]))
    flag_bal = [max(GWEI, int(sums[1 + f])) for f in range(3)]
    scal = api._epoch_scalars(
        engine, spec, E, 8, 9, True,
        GWEI * spec.base_reward_factor // helpers.integer_squareroot(total),
        total // GWEI, flag_bal, 0, total)
    planes = {"eff": pre.effective_balance, "bal": pre.balance,
              "slashed": pre.slashed.astype(np.uint8),
              "act": pre.activation_epoch, "exitp": pre.exit_epoch,
              "wd": pre.withdrawable_epoch, "scores": pre.inactivity_scores,
              "pflags": pre.previous_flags, "cflags": pre.current_flags}
    _, (_, jax_bal, _) = _jax_kernels(planes, scal)
    _, (_, port_bal, _) = _port_kernels(planes, scal)
    assert int(jax_bal[7]) == int(port_bal[7]) == wrapped


def test_from_arrays_takes_the_jax_snapshot():
    jstate = _jax_state(44, "altair", 4, 2)
    jsnap = jsoa.RegistrySoA.snapshot(jstate)
    mine = soa.RegistrySoA.from_arrays(
        **{k: getattr(jsnap, k) for k in soa.RegistrySoA.PLANES})
    ref = soa.RegistrySoA.snapshot(_port(jstate))
    for k in soa.RegistrySoA.PLANES:
        assert np.array_equal(getattr(mine, k), getattr(ref, k))
        assert getattr(mine, k).dtype == getattr(ref, k).dtype
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(jk.k_sums)(
            jsnap.effective_balance, jsnap.activation_epoch,
            jsnap.exit_epoch, jsnap.slashed, jsnap.previous_flags,
            jsnap.current_flags, np.asarray([3, 4], np.uint64)))
    assert np.array_equal(kernel.run_sums(mine, 3, 4, CPU), want)
    with pytest.raises(ValueError, match="planes"):
        soa.RegistrySoA.from_arrays(balance=jsnap.balance)


def test_validator_root_plane_equals_the_element_roots():
    jstate = _jax_state(45, "deneb", 4, 2, n=40)
    state = _port(jstate)
    state.validators[3].slashed = True
    state.validators[5].exit_epoch = 77
    plane = soa.validator_root_plane(state.validators,
                                     soa.RegistrySoA.snapshot(state))
    want = [ty.Validator.hash_tree_root(v) for v in state.validators]
    assert plane == want
    jstate.validators[3].slashed = True
    jstate.validators[5].exit_epoch = 77
    assert plane == jsoa.validator_root_plane(
        jstate.validators, jsoa.RegistrySoA.snapshot(jstate))
    assert hapi.engine_status()["digests"]["cuda"] >= 40 * 8


@pytest.mark.parametrize("mutate", [
    lambda lst: lst.append(object()), lambda lst: lst.extend([object()]),
    lambda lst: lst.insert(0, object()), lambda lst: lst.remove(lst[0]),
    lambda lst: lst.pop(), lambda lst: lst.clear(),
    lambda lst: lst.sort(key=id), lambda lst: lst.reverse(),
    lambda lst: lst.__setitem__(0, object()),
    lambda lst: lst.__delitem__(0), lambda lst: lst.__iadd__([object()]),
    lambda lst: lst.__imul__(2)])
def test_every_registry_list_mutator_drops_the_plane(mutate):
    lst = soa.RegistryList([object(), object()])
    calls = []
    lst._set_root_source(lambda: calls.append(1) or [b"\x11" * 32] * 2)
    assert lst._leaf_roots() == [b"\x11" * 32] * 2
    assert lst._leaf_roots() == [b"\x11" * 32] * 2 and calls == [1]
    mutate(lst)
    assert lst._leaf_roots() is None


def test_validator_mutators_drop_the_plane():
    state = _port(_jax_state(46, "altair", 4, 2))
    _process(state, "cuda")
    assert state.validators._leaf_roots() is not None
    helpers.initiate_validator_exit(state, 1, E, SPECS["altair"])
    assert state.validators._leaf_roots() is None
    _process(state, "cuda")
    helpers.slash_validator(state, 2, E, SPECS["altair"])
    assert state.validators._leaf_roots() is None
