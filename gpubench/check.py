"""The comparison that decides ``correct``: the program's sampled answers
against the float64 reference (``reference/qp.py``), solved anew from the
raw inputs. The numbers a cell's JSON gives a limit are compared with
it.

Numbers (each a maximum over the sampled instances):

* ``unsolved``: instances of the whole window whose status is not > 0.
* ``ref_failed``: sampled instances the reference could not solve.
* ``obj_gap``: |f(x) - f(x*)| / max(1, |f(x*)|), the configuration's own
  accuracy statistic (bench.py's audit).
* ``x_err``: |x - x*|_inf / |x*|_inf.
* ``primal_viol``: the largest violation of a row or bound, each scaled by
  1 + the size of its right-hand side (chip_smoke.py::check_ineq,
  :874-890).
* ``dual_resid`` (entries that return multipliers): the stationarity
  residual |Vx + q + A'lam_eq + G'lam_in - gamma|_inf and every sign or
  complementarity breach of the multipliers against the statuses S that the
  program returns (gamma on a free coordinate, gamma < 0 at a lower bound,
  > 0 at an upper one, lam_in < 0 on an active row, != 0 on an inactive
  one), each over 1 + |q|_inf.
* ``ret_risk_err`` (sweeps): the returned r'x and sqrt(x'Vx) against the
  optimum's, relative.
"""

from __future__ import annotations

import torch

from gpubench.reference import qp as ref

IN, DN, UP, OE, EO = 0, 1, 2, 3, 4  # the program's status codes


def numbers(p, D, q, rows: dict, unsolved: int, sol=None) -> dict:
    """The compared numbers of the sampled ``rows`` (x, S, status, and lam,
    gamma or ret, risk where the entry returns them), whose instances have
    the float64 data ``D`` and linear terms ``q`` (from the traffic kind's
    ``reference``). ``sol`` is the float64 reference's solution, solved here
    when not given."""
    if sol is None:
        sol = ref.solve(D, q)
    x = rows["x"].double()
    xs = sol.x
    f = ref.objective(D.V, q, x)
    fs = ref.objective(D.V, q, xs)
    out = {"unsolved": float(unsolved),
           "ref_failed": float((~sol.ok).sum())}
    out["obj_gap"] = _max((f - fs).abs() / fs.abs().clamp(min=1.0))
    out["x_err"] = _max((x - xs).abs().amax(-1) / xs.abs().amax(-1))
    out["primal_viol"] = _max(_primal(D, x))
    if rows.get("lam") is not None:
        out["dual_resid"] = _max(_dual(D, q, x, rows))
    if rows.get("ret") is not None:
        rets = p.rets.double()
        ret_s = xs @ rets
        risk_s = ((xs @ D.V) * xs).sum(-1).clamp(min=0.0).sqrt()
        err = torch.maximum((rows["ret"].double() - ret_s).abs() / ret_s.abs(),
                            (rows["risk"].double() - risk_s).abs() / risk_s)
        out["ret_risk_err"] = _max(err)
    return out


def _max(t: torch.Tensor) -> float:
    """The largest entry; NaN if any entry is not finite."""
    t = t.double()
    if not bool(torch.isfinite(t).all()):
        return float("nan")
    return float(t.max()) if t.numel() else 0.0


def _primal(D, x):
    span = 1.0 + torch.maximum(D.d.abs(), D.u.abs())
    parts = [((D.d - x) / span).amax(-1), ((x - D.u) / span).amax(-1)]
    if D.A.shape[0]:
        parts.append(((x @ D.A.T - D.b).abs() / (1.0 + D.b.abs())).amax(-1))
    if D.G.shape[0]:
        parts.append(((x @ D.G.T - D.g) / (1.0 + D.g.abs())).amax(-1))
    return torch.stack(parts, -1).amax(-1).clamp(min=0.0)


def _dual(D, q, x, rows):
    M, N = D.A.shape[0], x.shape[1]
    lam, gamma = rows["lam"].double(), rows["gamma"].double()
    S = rows["S"]
    st = x @ D.V + q + lam[:, :M] @ D.A - gamma
    if D.G.shape[0]:
        st = st + lam[:, M:] @ D.G
    Sx = S[:, :N]
    zero = torch.zeros_like(gamma)
    sign = torch.where(Sx == IN, gamma.abs(),
                       torch.where(Sx == DN, (-gamma).clamp(min=0.0),
                                   torch.where(Sx == UP, gamma.clamp(min=0.0),
                                               zero)))
    parts = [st.abs().amax(-1), sign.amax(-1)]
    if D.G.shape[0]:
        li, Se = lam[:, M:], S[:, N:]
        parts.append(torch.where(Se == EO, (-li).clamp(min=0.0),
                                 li.abs()).amax(-1))
    return torch.stack(parts, -1).amax(-1) / (1.0 + q.abs().amax(-1))


def control_rows(p, D, q, param, precision: str, sweep: bool):
    """The reference put in the program's place one precision step below
    the cell's: ``tf32`` (inputs rounded to TF32, TF32 products) for a
    float32 cell, ``float32`` for a float64 one. Returns rows shaped as an
    entry's view (with r'x and sqrt(x'Vx) where ``sweep``)."""
    tf32 = precision == "tf32"
    sol = ref.solve(D, q, dtype=torch.float32, tf32=tf32)
    N = q.shape[1]
    S = torch.full((q.shape[0], N + sol.active.shape[1]), IN,
                   dtype=torch.int8, device=q.device)
    S[:, :N] = torch.where(sol.lower, DN, torch.where(sol.upper, UP, IN))
    S[:, N:] = torch.where(sol.active, EO, OE)
    rows = dict(x=sol.x, S=S, status=sol.ok.to(torch.int32), lam=sol.lam,
                gamma=sol.gamma, param=param)
    if sweep:
        rnd = ref.round_tf32 if tf32 else (lambda t: t)
        with ref.matmul_precision(tf32):
            rets, V = rnd(p.rets.float()), rnd(D.V.float())
            rows["ret"] = sol.x @ rets
            rows["risk"] = ((sol.x @ V) * sol.x).sum(-1).clamp(min=0.0).sqrt()
    return rows


def judge(values: dict, limits: dict) -> tuple:
    """(correct, checks): each number the cell gives a limit beside it; a
    NaN or a number above its limit fails. A limit on a number the cell's
    entry cannot give is an error."""
    missing = sorted(set(limits) - set(values))
    if missing:
        raise KeyError(f"limits on numbers this entry does not give: "
                       f"{missing}")
    checks = {k: {"value": values[k], "limit": lim}
              for k, lim in limits.items()}
    ok = all(c["value"] == c["value"] and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
