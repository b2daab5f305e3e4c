"""The hand-written CUDA ADMM block against its plain PyTorch version,
on the card. Imports neither JAX nor the JAX package, so it runs where
only the port is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a CUDA device every test marked ``cuda`` skips: the kernel has
no CPU mode (the build lock's test stubs the compiler and runs
everywhere)."""

import numpy as np
import pytest
import torch

from mpisppy_tpu_torch.ops import qp_solver as T
from mpisppy_tpu_torch.ops.kernels import admm_block


def _tiny(S, device, seed=2, m=6, n=4, density=1.0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)) * (rng.random((m, n)) < density)
    P = np.abs(rng.normal(size=n)) + 0.5
    mid = rng.normal(size=(S, m))
    arrs = (P, A, mid - 3.0, mid + 3.0, np.full((S, n), -5.0),
            np.full((S, n), 5.0))
    d = T.QPData(*(torch.as_tensor(a, device=device) for a in arrs))
    q = torch.as_tensor(rng.normal(size=(S, n)), device=device)
    f = T.qp_setup(d, q_ref=q)
    return f, d, q, T.qp_cold_state(f, d)


def _l_inv(f, st):
    """The state with an L⁻¹-pair solve operator of the same KKT."""
    g = f.Eb * f.D
    M = f.A_s.T @ (f.rho_A.unsqueeze(-1) * f.A_s) \
        + torch.diag(f.P_s + f.sigma + g * g * f.rho_b)
    Lc = torch.linalg.cholesky(M)
    eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
    return st._replace(L=T.LInv(torch.linalg.solve_triangular(
        Lc, eye, upper=False).contiguous(), Lc))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("l_inv", [False, True])
@pytest.mark.parametrize("S", [1, 4, 19])
def test_kernel_matches_plain(cuda, l_inv, S):
    """20 steps; |kernel − plain| ≤ 1e-9 × max(1, |plain|): f64 with a
    different order of summation."""
    f, d, q, st = _tiny(S, cuda)
    if l_inv:
        st = _l_inv(f, st)
    before = admm_block.LAUNCHES
    got = admm_block.fused_admm_block(f, d, q, st, n_steps=20, scen_tile=0)
    torch.cuda.synchronize()
    # the count the library exports: it does not depend on how many
    # scenario groups (grid.y) the rows fill
    assert admm_block.LAUNCHES - before \
        == admm_block.admm_block_launches(20, l_inv)
    g, l_s, u_s, lb_s, ub_s, csx, q_s = T._scaled_problem(f, d, q)
    F = st.L.inv if l_inv else st.L
    ref = admm_block.admm_block_plain(
        f.A_s, F, f.P_s, g, q_s, l_s, u_s, lb_s, ub_s, f.rho_A, f.rho_b,
        1.0 / f.E, 1.0 / f.Eb, 1.0 / (f.D * csx), f.D, st.x, st.yA, st.yB,
        st.zA, st.zB, sigma=f.sigma, n_steps=20, l_inv_pair=l_inv)
    for a, b in zip(ref, got):
        scale = max(1.0, float(a.abs().max()))
        assert float((b - a).abs().max()) <= 1e-9 * scale


def _against_plain_two_orders(f, d, q, st, l_inv):
    """20 kernel steps against the plain version; the bar adds four
    times the spread between two summation orders of the plain version
    (batched, and one scenario row at a time)."""
    S = st.x.shape[0]
    got = admm_block.fused_admm_block(f, d, q, st, n_steps=20, scen_tile=0)
    g, l_s, u_s, lb_s, ub_s, csx, q_s = T._scaled_problem(f, d, q)
    F = st.L.inv if l_inv else st.L
    ops = [f.A_s, F, f.P_s, g, q_s, l_s, u_s, lb_s, ub_s, f.rho_A, f.rho_b,
           1.0 / f.E, 1.0 / f.Eb, 1.0 / (f.D * csx), f.D, st.x, st.yA,
           st.yB, st.zA, st.zB]
    kw = dict(sigma=f.sigma, n_steps=20, l_inv_pair=l_inv)
    ref = admm_block.admm_block_plain(*ops, **kw)
    per = {4, 5, 6, 7, 8, 15, 16, 17, 18, 19}
    rows = [admm_block.admm_block_plain(
        *[o[s:s + 1] if i in per else o for i, o in enumerate(ops)], **kw)
        for s in range(S)]
    alt = [torch.cat(p) for p in zip(*rows)]
    for a, b, c in zip(ref, got, alt):
        assert bool(torch.isfinite(b).all())
        tol = 1e-9 * max(1.0, float(a.abs().max())) \
            + 4.0 * float((c - a).abs().max())
        assert float((b - a).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("l_inv", [False, True])
def test_kernel_matches_plain_multi_tile(cuda, l_inv):
    """Shapes that run every tile loop of the kernel more than once,
    with ragged last tiles (m = 1000, n = 600)."""
    f, d, q, st = _tiny(10, cuda, m=1000, n=600, density=0.01)
    if l_inv:
        st = _l_inv(f, st)
    _against_plain_two_orders(f, d, q, st, l_inv)


@pytest.mark.cuda
@pytest.mark.parametrize("l_inv", [False, True])
@pytest.mark.parametrize("S", [1, 10, 16, 17])
@pytest.mark.parametrize("m,n", [(300, 200), (301, 199)])
def test_kernel_matches_plain_partial_tiles(cuda, m, n, S, l_inv):
    """Partial tiles on both axes of A and F and a split reduction axis
    whose last part and last stage are short (block_schedule splits
    every product at these shapes); n = 199 takes the 8-byte copies
    (rows not 16-byte aligned), S = 17 a partial second scenario
    group."""
    sched = admm_block.block_schedule(m, n)
    assert all(parts > 1 for parts, _ in sched.values())
    f, d, q, st = _tiny(S, cuda, m=m, n=n)
    if l_inv:
        st = _l_inv(f, st)
    _against_plain_two_orders(f, d, q, st, l_inv)


@pytest.mark.cuda
def test_tiled_is_bit_equal_to_untiled(cuda):
    f, d, q, st = _tiny(48, cuda)
    a = admm_block.fused_admm_block(f, d, q, st, n_steps=20, scen_tile=0)
    b = admm_block.fused_admm_block(f, d, q, st, n_steps=20, scen_tile=16)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_tiled_is_bit_equal_to_untiled_two_groups_per_tile(cuda):
    """32-row scenario tiles hold two 16-row scenario groups each, and
    the shapes split every product's reduction axis."""
    f, d, q, st = _tiny(64, cuda, m=300, n=200)
    a = admm_block.fused_admm_block(f, d, q, st, n_steps=20, scen_tile=0)
    b = admm_block.fused_admm_block(f, d, q, st, n_steps=20, scen_tile=32)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_wrapper_rejects_bad_operands(cuda):
    f, d, q, st = _tiny(4, cuda)
    with pytest.raises(TypeError, match="float64"):
        admm_block.fused_admm_block(f, d, q, st._replace(
            x=st.x.float()), n_steps=1)


@pytest.mark.cuda
def test_wrapper_leaves_its_input_state_unchanged(cuda):
    """The wrapper hands the kernel clones of the iterates: chunk states
    share buffers (one cold state serves every chunk of a mode), so a
    call must not write the state it was given."""
    f, d, q, st = _tiny(19, cuda)
    st = st._replace(**dict(zip(("x", "yA", "yB", "zA", "zB"),
                                admm_block.fused_admm_block(
                                    f, d, q, st, n_steps=10)[:5])))
    before = {k: getattr(st, k).clone() for k in
              ("x", "yA", "yB", "zA", "zB", "L", "rho_scale")}
    out = admm_block.fused_admm_block(f, d, q, st, n_steps=20)
    torch.cuda.synchronize()
    assert not torch.equal(out[0], st.x)
    for k, v in before.items():
        assert torch.equal(getattr(st, k), v), k


@pytest.mark.cuda
def test_chunked_fused_ph_equals_unchunked(cuda):
    """UC 3 x 6, S = 8 in chunks of 4, fused mode on the kernel: x̄ and W
    after iter 0 and two prox-on iterations equal the unchunked run's to
    1e-12 x max(1, |.|) (the kernel's per-row summation order does not
    depend on the rows of the call, and with chunks of 4 and the polish
    in pairs every scenario meets the same pairs)."""
    from mpisppy_tpu_torch.core.ph import PH
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import uc

    batch = build_batch(uc.scenario_creator, uc.make_tree(8),
                        creator_kwargs={"num_gens": 3, "num_hours": 6},
                        vector_patch=uc.scenario_vector_patch)
    opts = {"defaultPHrho": 100.0, "PHIterLimit": 2,
            "subproblem_kernel_mode": "fused",
            "subproblem_kernel_backend": "cuda",
            "subproblem_max_iter": 400, "subproblem_polish_hot": False,
            "subproblem_polish_chunk": 2}
    a = PH(batch, {**opts, "subproblem_chunk": 4}, device=cuda)
    b = PH(batch, dict(opts), device=cuda)
    before = admm_block.LAUNCHES
    a.ph_main()
    assert admm_block.LAUNCHES - before \
        == 2 * 3 * admm_block.admm_block_launches(400, False)
    b.ph_main()
    assert a.phase_timing(True)["gate_d2h_syncs_per_call"] == 1.0
    for got, ref in ((a.xbar, b.xbar), (a.W, b.W)):
        scale = max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) <= 1e-12 * scale


def _uc_split_packed(device):
    """The packed split form of a UC 6 x 12 matrix (the structure the
    packed tests use) on ``device``."""
    from mpisppy_tpu_torch.ir.standard_form import lower
    from mpisppy_tpu_torch.models import uc
    from mpisppy_tpu_torch.ops import packed
    A = np.asarray(lower(uc.scenario_creator(
        "scen0", num_gens=6, num_hours=12, relax_integrality=True,
        min_up_down=True, ramping=True)).A, np.float64)
    st = packed.analyze_structure(*np.nonzero(A), *A.shape)
    sp = T.split_f32(torch.as_tensor(A, device=device))
    return A, sp, packed.pack(st, sp.hi), packed.pack(st, sp.lo)


@pytest.mark.cuda
def test_packed_split_apply_is_bit_reproducible_on_the_card(cuda):
    """The gather-only packed apply has no atomics: two calls on the card
    give the same bits, and the result matches the dense split product
    to the split's 2e-6 floor."""
    from mpisppy_tpu_torch.ops import packed
    A, sp, pk_hi, pk_lo = _uc_split_packed(cuda)
    m, n = A.shape
    rng = np.random.default_rng(5)
    for S, v_len, fn, size in ((16, n, packed.pk_Ax_split, m),
                               (16, m, packed.pk_ATy_split, n)):
        v = torch.as_tensor(rng.normal(size=(S, v_len)), device=cuda)
        vh = v.float()
        vl = (v - vh.double()).float()
        a = fn(pk_hi, pk_lo, vh, vl, size)
        b = fn(pk_hi, pk_lo, vh, vl, size)
        torch.cuda.synchronize()
        assert a.is_cuda and torch.equal(a, b)
        dense = (T._Ax if fn is packed.pk_Ax_split else T._ATy)(sp, v)
        assert float((a - dense).abs().max()) \
            <= 2e-6 * float(dense.abs().max())


@pytest.mark.cuda
def test_tf32_pin_holds_on_the_card(cuda):
    """The engine's device resolution pins full-precision f32 products:
    a TF32 product would land inside the split's 1e-7 floor. An f32
    matmul on the card then agrees with its f64 product to f32
    accumulation level, far below TF32's 2⁻¹¹."""
    from mpisppy_tpu_torch.utils.runtime import resolve_device
    resolve_device("cuda")
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    g = torch.Generator(device="cpu").manual_seed(0)
    a = torch.randn(256, 1024, generator=g, dtype=torch.float64)
    b = torch.randn(1024, 64, generator=g, dtype=torch.float64)
    got = (a.float().to(cuda) @ b.float().to(cuda)).double().cpu()
    ref = a.float().double() @ b.float().double()
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_two_threads_launch_bit_equal_to_serial(cuda):
    """The block launched from two threads at once (the wheel's cylinder
    threads share the card's default stream) gives the bits of two
    serial launches; each thread's own count books its launches, and
    the two add up to the global count."""
    import threading
    f, d, q, st = _tiny(10, cuda, m=301, n=199)
    serial = [admm_block.fused_admm_block(f, d, q, st, n_steps=20,
                                          scen_tile=0) for _ in range(2)]
    torch.cuda.synchronize()
    before = admm_block.LAUNCHES
    out, counts = [None, None], [0, 0]

    def run(i):
        n0 = admm_block.thread_launches()
        out[i] = admm_block.fused_admm_block(f, d, q, st, n_steps=20,
                                             scen_tile=0)
        torch.cuda.synchronize()
        counts[i] = admm_block.thread_launches() - n0

    ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for got, ref in zip(out, serial):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    per_call = admm_block.admm_block_launches(20, False)
    assert counts == [per_call, per_call]
    assert admm_block.LAUNCHES - before == sum(counts)


@pytest.mark.cuda
def test_per_engine_launch_counts_add_up(cuda):
    """Two engines over one UC batch, each solving through the block:
    each books its own launches (through its kernel plans) and the two
    add up to the module's global count."""
    from mpisppy_tpu_torch.core.ph import PHBase
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import uc
    batch = build_batch(uc.scenario_creator, uc.make_tree(4),
                        creator_kwargs={"num_gens": 3, "num_hours": 6},
                        vector_patch=uc.scenario_vector_patch)
    opts = {"defaultPHrho": 100.0, "subproblem_kernel_mode": "fused",
            "subproblem_kernel_backend": "cuda", "subproblem_max_iter": 40}
    a, b = PHBase(batch, dict(opts)), PHBase(batch, dict(opts))
    before = admm_block.LAUNCHES
    a.solve_loop(w_on=False, prox_on=False)
    b.solve_loop(w_on=False, prox_on=False)
    b.solve_loop(w_on=True, prox_on=True)
    torch.cuda.synchronize()
    assert a.kernel_launches > 0 and b.kernel_launches > a.kernel_launches
    assert a.kernel_launches + b.kernel_launches \
        == admm_block.LAUNCHES - before
    assert a.qp_data.A is b.qp_data.A      # the batch's device cache


def test_locked_build_runs_once_under_two_threads(monkeypatch, tmp_path):
    """Two threads' first launches race on _build.load: under its lock
    the library is built and loaded once. Runs everywhere: nvcc and the
    loader are stubbed, the lock is what is held."""
    import threading
    from mpisppy_tpu_torch.ops.kernels import _build
    calls = {"build": 0, "load": 0}

    def fake_build_all():
        calls["build"] += 1
        import time
        time.sleep(0.2)              # a slow build widens the race
        return {"admm_block": tmp_path / "lib.so"}

    def fake_cdll(path):
        calls["load"] += 1
        return object()

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build_all", fake_build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    libs = [None, None]

    def run(i):
        libs[i] = _build.load("admm_block")

    ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert calls == {"build": 1, "load": 1}
    assert libs[0] is libs[1] is not None


@pytest.mark.cuda
def test_locked_build_compiles_once_on_the_card(cuda, monkeypatch,
                                                 tmp_path):
    """The real build into an empty directory from two threads at once:
    one nvcc per source, one load, both threads get the same library."""
    import subprocess
    import threading
    from mpisppy_tpu_torch.ops.kernels import _build
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    n_src = len(list(_build.CSRC.glob("*.cu")))
    real_popen, spawned = subprocess.Popen, []

    def counting_popen(cmd, *a, **kw):
        spawned.append(cmd)
        return real_popen(cmd, *a, **kw)

    monkeypatch.setattr(_build.subprocess, "Popen", counting_popen)
    libs = [None, None]

    def run(i):
        libs[i] = _build.load("admm_block")

    ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(spawned) == n_src
    assert libs[0] is libs[1] is not None


# ---- APH φ-dispatch: the dispatch layout on the card ----

@pytest.mark.cuda
def test_gather_scatter_duplicate_pads_on_the_card(cuda):
    """The dispatch row moves on CUDA tensors: a gather with pad ids
    repeating the last one, and a scatter of the padded rows (duplicate
    ids carrying equal rows) that writes exactly them, as on the CPU."""
    from mpisppy_tpu_torch.ops.dispatch import gather_rows, scatter_rows
    rng = np.random.default_rng(5)
    full_h = torch.as_tensor(rng.normal(size=(40, 300)))
    full = full_h.to(cuda)
    idx_h = torch.as_tensor([2, 9, 17, 30, 33, 39, 39, 39])
    idx = idx_h.to(cuda)
    rows = gather_rows(full, idx)
    assert torch.equal(rows.cpu(), full_h[idx_h])
    out = scatter_rows(full, idx, rows * 3.0)
    torch.cuda.synchronize()
    ref = scatter_rows(full_h, idx_h, full_h[idx_h] * 3.0)
    assert torch.equal(out.cpu(), ref)
    assert torch.equal(full.cpu(), full_h)


@pytest.mark.cuda
def test_block_on_gathered_padded_rows_matches_plain(cuda):
    """The block on a dispatch pass's operands: chunk-state rows
    gathered from the full-width row store for the ids [0, 3, 6] padded
    to a chunk of 4 by repeating 6, against its plain version."""
    from mpisppy_tpu_torch.core.ph import PH, _ph_assemble
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import uc
    from mpisppy_tpu_torch.ops.dispatch import gather_rows

    batch = build_batch(uc.scenario_creator, uc.make_tree(8),
                        creator_kwargs={"num_gens": 3, "num_hours": 6},
                        vector_patch=uc.scenario_vector_patch)
    ph = PH(batch, {"defaultPHrho": 100.0, "PHIterLimit": 1,
                    "subproblem_kernel_mode": "fused",
                    "subproblem_kernel_backend": "cuda",
                    "subproblem_max_iter": 400,
                    "subproblem_polish_hot": False,
                    "subproblem_polish_chunk": 2, "subproblem_chunk": 4},
            device=cuda)
    ph.ph_main()
    f, data = ph._get_factors(True)
    slices, ids_pad = ph._dispatch_slices(np.array([0, 3, 6]), 4)
    assert ids_pad.tolist() == [0, 3, 6, 6]
    idx, real = slices[0]
    assert real == 3
    store = ph._dispatch_store(True, f, data, slices)
    st = store._replace(**{k: gather_rows(getattr(store, k), idx)
                           for k in ("x", "yA", "yB", "zA", "zB", "pri_res",
                                     "dua_res", "pri_rel", "dua_rel")})
    d = data._replace(l=data.l[idx], u=data.u[idx], lb=data.lb[idx],
                      ub=data.ub[idx])
    q, bl, bu = _ph_assemble(d, ph.c[idx], ph.W[idx], ph.xbar[idx],
                             ph.rho[idx], ph.nonant_idx,
                             ph._fixed_mask[idx], ph._fixed_vals[idx],
                             None, w_on=True, prox_on=True)
    _against_plain_two_orders(f, d._replace(lb=bl, ub=bu), q, st, False)


@pytest.mark.cuda
def test_block_on_pinned_lshaped_operands_matches_plain(cuda):
    """The block on an L-shaped cut solve's operands: the eq-boosted
    pinned factors (the fixed=True plan), every nonant box pinned at
    the rounded master point, the pinned state rebuilt cold from the
    prox-off iterates as every cut solve rebuilds it; the engine's eta
    bounds and its cut solve launched the block on both plans."""
    from mpisppy_tpu_torch.core.lshaped import LShapedMethod
    from mpisppy_tpu_torch.core.ph import _ph_assemble
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import uc

    batch = build_batch(uc.scenario_creator, uc.make_tree(3),
                        creator_kwargs={"num_gens": 3, "num_hours": 6},
                        vector_patch=uc.scenario_vector_patch)
    ls = LShapedMethod(batch, {"defaultPHrho": 100.0,
                               "subproblem_kernel_mode": "fused",
                               "subproblem_kernel_backend": "cuda",
                               "subproblem_max_iter": 400,
                               "subproblem_polish_chunk": 2},
                       device=cuda)
    ls.set_eta_bounds()
    xf, _, _ = ls.solve_master()
    ls.generate_cuts(xf)
    for key in (False, ("fixed", False)):
        plan = ls._kernel_plans[key]
        assert plan.backend == "cuda" and plan.launches > 0, key
    ls._qp_states.pop(("fixed", False), None)
    st = ls._ensure_state(False, fixed=True)
    f, data = ls._get_factors(False, fixed=True)
    ls.fix_nonants(ls.round_nonants(xf))
    q, bl, bu = _ph_assemble(data, ls.c, ls.W, ls.xbar, ls.rho,
                             ls.nonant_idx, ls._fixed_mask, ls._fixed_vals,
                             None, w_on=False, prox_on=False)
    ls.unfix_nonants()
    assert bool((bl[:, ls.nonant_idx] == bu[:, ls.nonant_idx]).all())
    _against_plain_two_orders(f, data._replace(lb=bl, ub=bu), q, st, False)


_UC_BLOCK_OPTS = {"defaultPHrho": 100.0, "PHIterLimit": 1,
                  "convthresh": -1.0, "subproblem_kernel_mode": "fused",
                  "subproblem_kernel_backend": "cuda",
                  "subproblem_max_iter": 400,
                  "subproblem_polish_hot": False,
                  "subproblem_polish_chunk": 2}


def _uc_batch(S):
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import uc
    return build_batch(uc.scenario_creator, uc.make_tree(S),
                       creator_kwargs={"num_gens": 3, "num_hours": 6},
                       vector_patch=uc.scenario_vector_patch)


@pytest.mark.cuda
def test_block_on_bundled_uc_matches_plain(cuda):
    """The block on a bundled UC (6 scenarios in 3 bundles of 2): the
    bundles share one 2-D matrix, the engine's plans are the cuda block
    and launched, and 20 kernel steps on the prox-on state after one PH
    iteration match the plain version."""
    from mpisppy_tpu_torch.core.bundles import form_bundles
    from mpisppy_tpu_torch.core.ph import PH, _ph_assemble

    bundled = form_bundles(_uc_batch(6), 3)
    assert bundled.shared_A
    ph = PH(bundled, dict(_UC_BLOCK_OPTS), device=cuda)
    ph.ph_main(finalize=False)
    assert ph.qp_data.A.ndim == 2
    for key, plan in ph._kernel_plans.items():
        assert plan.backend == "cuda" and plan.launches > 0, key
    f, data = ph._get_factors(True)
    q, _, _ = _ph_assemble(data, ph.c, ph.W, ph.xbar, ph.rho,
                           ph.nonant_idx, ph._fixed_mask, ph._fixed_vals,
                           None, w_on=True, prox_on=True)
    _against_plain_two_orders(f, data, q, ph._qp_states[True], False)


@pytest.mark.cuda
@pytest.mark.parametrize("G,T,S,chunk", [(3, 6, 8, 3), (10, 24, 10, 0)],
                         ids=["uc3x6-chunked", "uc10x24"])
def test_block_on_compacted_uc_matches_plain(cuda, G, T, S, chunk):
    """The block on the COMPACTED UC system (the device fixer pins about
    three quarters of the nonant slots by iteration 4, buckets 0.5 and
    0.75): the compacted modes run their own cuda plans, which launch,
    and 20 kernel steps on the first compacted solve's operands and on
    the last prox-on state match the plain version; (m_c, n_c) are not
    multiples of the kernel's tiles."""
    import mpisppy_tpu_torch.core.ph as ph_mod
    from mpisppy_tpu_torch.core.ph import PH
    from mpisppy_tpu_torch.extensions.fixer import uniform_fix_list
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import uc

    batch = build_batch(uc.scenario_creator, uc.make_tree(S),
                        creator_kwargs={"num_gens": G, "num_hours": T},
                        vector_patch=uc.scenario_vector_patch)
    opts = dict(_UC_BLOCK_OPTS, PHIterLimit=6, shrink_fix=True,
                shrink_compact=True, shrink_buckets="0.5,0.75",
                id_fix_list_fct=lambda b: uniform_fix_list(
                    b, tol=1e-2, nb=2, lb=2, ub=2, integer_only=False))
    if chunk:
        opts["subproblem_chunk"] = chunk
    ph = PH(batch, opts, device=cuda)
    first = {}
    orig = ph_mod._solver_call

    def spy(f, d, q, st, **kw):
        if ph._shrink is not None and not first:
            first.update(f=f, d=d, q=q, st=st)
        return orig(f, d, q, st, **kw)

    ph_mod._solver_call = spy
    try:
        ph.ph_main(finalize=False)
    finally:
        ph_mod._solver_call = orig
    shrink = ph._shrink
    assert shrink is not None and first
    n_c, m_c = shrink.n_c, shrink.m_c
    assert n_c < batch.n
    assert n_c % admm_block.COL_TILE and m_c % admm_block.ROW_TILE
    plan = ph._kernel_plans[True]
    assert plan.backend == "cuda" and plan.launches > 0
    _against_plain_two_orders(first["f"], first["d"], first["q"],
                              first["st"], False)
    f, data = ph._get_factors(True)
    st = ph._chunk_states[True][0] if chunk else ph._qp_states[True]
    rows = st.x.shape[0]
    idx = torch.arange(rows, device=cuda)
    asm = ph._assembly_operands(shrink)
    q, bl, bu = ph_mod._ph_assemble(
        data._replace(l=data.l[idx], u=data.u[idx], lb=data.lb[idx],
                      ub=data.ub[idx]),
        asm["c"][idx], asm["W"][idx], asm["xbar"][idx], asm["rho"][idx],
        asm["idx"], asm["fm"][idx], asm["fv"][idx], None, w_on=True,
        prox_on=True)
    d = data._replace(l=data.l[idx], u=data.u[idx], lb=bl, ub=bu)
    _against_plain_two_orders(f, d, q, st, False)


@pytest.mark.cuda
def test_block_on_fwph_linearized_state_matches_plain(cuda):
    """The block on FWPH's linearized operands: the prox-off factor and
    the warm state its last linearized solve left, the cost at the
    w_t = W + ρ(x_t − x̄) of the next pass (E[w_t] = 0 there); the
    engine launched the block on its prox-off plan."""
    from mpisppy_tpu_torch.core.fwph import FWPH
    from mpisppy_tpu_torch.core.ph import _ph_assemble

    fw = FWPH(_uc_batch(3), dict(_UC_BLOCK_OPTS, PHIterLimit=2,
                                 FW_iter_limit=2, fwph_max_columns=4),
              device=cuda)
    fw.fwph_main(finalize=False)
    plan = fw._kernel_plans[False]
    assert plan.backend == "cuda" and plan.launches > 0
    w_t = fw.W + fw.rho * (fw._xn_t - fw.xbar)
    assert float((fw.prob @ w_t).abs().max()) \
        <= 1e-9 * max(1.0, float(w_t.abs().max()))
    f, data = fw._get_factors(False)
    q, _, _ = _ph_assemble(data, fw.c, w_t, fw.xbar, fw.rho, fw.nonant_idx,
                           fw._fixed_mask, fw._fixed_vals, None, w_on=True,
                           prox_on=False)
    _against_plain_two_orders(f, data, q, fw._qp_states[False], False)


@pytest.mark.cuda
def test_certified_cuts_hold_on_the_card(cuda):
    """The L-shaped cut builder on the card, on duals that certify
    finite cuts: a small UC's cut solve on the reference backend (rho
    adapts) at the first master point, which the pinned solve finds
    feasible. Every scenario's cut is finite, holds at the point
    (tests/test_lshaped.py's bar) and lies within 1e-3 relative of the
    pinned objective there (a tight cut)."""
    from mpisppy_tpu_torch.core.lshaped import LShapedMethod
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import uc

    batch = build_batch(uc.scenario_creator, uc.make_tree(3),
                        creator_kwargs={"num_gens": 3, "num_hours": 6},
                        vector_patch=uc.scenario_vector_patch)
    ls = LShapedMethod(batch, {"defaultPHrho": 100.0,
                               "subproblem_kernel_mode": "segmented"},
                       device=cuda)
    ls.set_eta_bounds()
    xf, _, _ = ls.solve_master()
    const, g, ub = ls.generate_cuts(xf)
    assert ls._cut_timing["feasible"] and ub is not None
    x = ls.round_nonants(xf)
    V = ls._last_base_obj.cpu().numpy()
    cut = const + g @ x
    assert np.all(np.isfinite(cut))
    scale = np.maximum(1.0, np.abs(V))
    assert np.all(cut <= V + 1e-4 * scale)
    assert np.all(V - cut <= 1e-3 * scale)


def _child_window_from_the_card(name, length):
    """A spawned process with its own CUDA context: computes on the card
    and publishes the result through the shared window."""
    from mpisppy_tpu_torch.cylinders.spcommunicator import Window
    v = (torch.arange(length, dtype=torch.float64, device="cuda") * 2.0)
    w = Window.shared(name, length, create=False)
    try:
        w.put(v.cpu().numpy())
    finally:
        w.close(unlink=False)


@pytest.mark.cuda
def test_two_processes_open_one_shared_window(cuda):
    """The process wheels' transport with CUDA in both processes: the
    parent holds a CUDA context and creates the window, a spawned child
    opens it and writes a result computed on the card."""
    import multiprocessing as mp
    import os
    from mpisppy_tpu_torch.cylinders.spcommunicator import Window
    torch.zeros(1, device=cuda)            # the parent's CUDA context
    name = f"/spwcuda{os.getpid():x}"
    w = Window.shared(name, 5, create=True)
    try:
        p = mp.get_context("spawn").Process(
            target=_child_window_from_the_card, args=(name, 5))
        p.start()
        p.join(timeout=120)
        assert not p.is_alive() and p.exitcode == 0
        vals, wid = w.read()
        assert wid == 1 and vals.tolist() == [0.0, 2.0, 4.0, 6.0, 8.0]
    finally:
        w.close()


@pytest.mark.cuda
def test_stream_pipeline_side_stream_pinned_and_bit_equal(cuda):
    """The streamed source's card path (stream/pipeline.py): chunks
    cross from a reused ring of pinned buffers on a side stream, a copy
    completes while the default stream is still busy, and after 50
    passes (gated and not) under allocator churn every staged block
    equals the host rows bit for bit."""
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import uc
    from mpisppy_tpu_torch.stream.source import StreamedSource
    b = build_batch(uc.scenario_creator, uc.make_tree(12),
                    creator_kwargs={"num_gens": 10, "num_hours": 24},
                    vector_patch=uc.scenario_vector_patch)
    src = StreamedSource(b, torch.float64, cuda, depth=2)
    ids = [np.arange(i, i + 4) for i in range(0, 12, 4)]
    src.bind(("t",), ids)
    ref = {f: torch.as_tensor(np.asarray(getattr(b, f)), device=cuda)
           for f in src.fields}
    bad = torch.zeros((), dtype=torch.bool, device=cuda)
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(2048, 2048, dtype=torch.float64, device=cuda)
    for p in range(50):
        gated = p % 2 == 0
        src.begin_pass(gated=gated)
        for ci, rows in enumerate(ids):
            blk = src.chunk(ci)
            if gated:
                src.release(ci)
            # keep the default stream busy and churn the allocator
            y = x @ x
            junk = [torch.empty(int(torch.randint(1, 1 << 20, (1,),
                                                  generator=gen)),
                                device=cuda) for _ in range(4)]
            r = torch.as_tensor(rows, device=cuda)
            for f in src.fields:
                bad |= (blk[f] != ref[f][r]).any()
            del blk, y, junk
    torch.cuda.synchronize()
    assert not bool(bad)
    ring = src._stager._ring
    assert all(t.is_pinned() for slot in ring for t in slot.values())
    assert src._stager.stream != torch.cuda.current_stream(cuda)
    # overlap: a chunk's copy completes while the default stream is busy
    busy_end = torch.cuda.Event()
    for _ in range(100):        # ~40 ms of f64 products
        x = x @ x / 2048.0
    busy_end.record()
    src.begin_pass()
    blk, ev = src._pipeline.get(0)
    ev.synchronize()
    assert not busy_end.query()
    torch.cuda.synchronize()
    src.close()
    assert not src.prefetch_alive
