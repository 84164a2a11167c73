"""IAPWS-95 water/steam properties on torch tensors (counterpart of
``dispatches_tpu/properties/iapws95.py``).

The full Helmholtz-energy formulation (IAPWS Release 1995 / Wagner &
Pruss 2002, J. Phys. Chem. Ref. Data 31:387): the ideal-gas part
``phi0(delta, tau)`` and the 56-term residual part ``phir(delta, tau)``.
Every thermodynamic property is an explicit expression in those fields
and their partial derivatives, so properties batch over any shape (one
call evaluates the EoS for every stream of a flowsheet at once) and
differentiate to any order.

The first and second partials are written in closed form (the
derivative tables of the Release), not taken by nested autograd: they
are exact, they cost one pass over the 56 terms, and they are ordinary
tensor expressions, so ``torch.func.jacfwd`` of a flowsheet residual
built on ``phir_d`` and the IPM's Hessian passes differentiate them
again.  The guards that keep derivatives finite at delta = 1 are those
of the reference: the double ``where`` around ``delta ** c`` and the
``+ 1e-30`` in ``(delta - 1)**2`` and ``Delta`` of the nonanalytic
terms; ``phi0`` uses ``expm1``.

The public property functions take tensors (numbers and numpy arrays
become float64 CPU tensors) and run where their inputs live.  The
iterative helpers (``sat_solve_T``, ``sat_solve_P``, ``rho_tp``,
``props_tp``, ``flash_hp``, ``h_ps``) are host-side warm-start
utilities for initialization ladders: they run the same closed forms in
float64 numpy, so a scalar Newton step never becomes a device launch.

All thermodynamic functions use MOLAR SI units (J/mol, mol/s) matching
the Helm state (flow_mol, enth_mol, pressure), with ``delta = rho /
RHOC`` the reduced density and temperature in K.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

# ----------------------------------------------------------------------
# Constants (IAPWS-95 Release; Wagner & Pruss 2002 Table 6.1/6.2)
# ----------------------------------------------------------------------

TC = 647.096  # K, critical temperature
RHOC = 322.0  # kg/m^3, critical density
PC = 22.064e6  # Pa, critical pressure
R_MASS = 461.51805  # J/(kg K), specific gas constant
MW = 0.01801528  # kg/mol
R_MOL = R_MASS * MW  # J/(mol K)

# Ideal-gas part (Table 6.1; n1/n2 from the revised release, h = u = 0
# for saturated liquid at the triple point)
_N0 = np.array([-8.3204464837497, 6.6832105275932, 3.00632])
_N0E = np.array([0.012436, 0.97315, 1.27950, 0.96956, 0.24873])
_G0E = np.array([1.28728967, 3.53734222, 7.74073708, 9.24437796, 27.5075105])

# Residual part (Table 6.2): terms 1-7 polynomial, 8-51 exponential,
# 52-54 Gaussian, 55-56 nonanalytic.
_C = np.array([0] * 7 + [1] * 15 + [2] * 20 + [3] * 4 + [4] + [6] * 4, dtype=np.float64)
_D = np.array(
    [1, 1, 1, 2, 2, 3, 4,
     1, 1, 1, 2, 2, 3, 4, 4, 5, 7, 9, 10, 11, 13, 15,
     1, 2, 2, 2, 3, 4, 4, 4, 5, 6, 6, 7, 9, 9, 9, 9, 9, 10, 10, 12,
     3, 4, 4, 5, 14, 3, 6, 6, 6],
    dtype=np.float64,
)
_T = np.array(
    [-0.5, 0.875, 1.0, 0.5, 0.75, 0.375, 1.0,
     4.0, 6.0, 12.0, 1.0, 5.0, 4.0, 2.0, 13.0, 9.0, 3.0, 4.0, 11.0, 4.0,
     13.0, 1.0,
     7.0, 1.0, 9.0, 10.0, 10.0, 3.0, 7.0, 10.0, 10.0, 6.0, 10.0, 10.0,
     1.0, 2.0, 3.0, 4.0, 8.0, 6.0, 9.0, 8.0,
     16.0, 22.0, 23.0, 23.0, 10.0, 50.0, 44.0, 46.0, 50.0],
    dtype=np.float64,
)
_N = np.array(
    [0.12533547935523e-1, 0.78957634722828e1, -0.87803203303561e1,
     0.31802509345418, -0.26145533859358, -0.78199751687981e-2,
     0.88089493102134e-2,
     -0.66856572307965, 0.20433810950965, -0.66212605039687e-4,
     -0.19232721156002, -0.25709043003438, 0.16074868486251,
     -0.40092828925807e-1, 0.39343422603254e-6, -0.75941377088144e-5,
     0.56250979351888e-3, -0.15608652257135e-4, 0.11537996422951e-8,
     0.36582165144204e-6, -0.13251180074668e-11, -0.62639586912454e-9,
     -0.10793600908932, 0.17611491008752e-1, 0.22132295167546,
     -0.40247669763528, 0.58083399985759, 0.49969146990806e-2,
     -0.31358700712549e-1, -0.74315929710341, 0.47807329915480,
     0.20527940895948e-1, -0.13636435110343, 0.14180634400617e-1,
     0.83326504880713e-2, -0.29052336009585e-1, 0.38615085574206e-1,
     -0.20393486513704e-1, -0.16554050063734e-2, 0.19955571979541e-2,
     0.15870308324157e-3, -0.16388568342530e-4,
     0.43613615723811e-1, 0.34994005463765e-1, -0.76788197844621e-1,
     0.22446277332006e-1, -0.62689710414685e-4, -0.55711118565645e-9,
     -0.19905718354408, 0.31777497330738, -0.11841182425981],
    dtype=np.float64,
)

# Gaussian terms 52-54
_NG = np.array([-0.31306260323435e2, 0.31546140237781e2, -0.25213154341695e4])
_DG = np.array([3.0, 3.0, 3.0])
_TG = np.array([0.0, 1.0, 4.0])
_ALPHA = np.array([20.0, 20.0, 20.0])
_BETA_G = np.array([150.0, 150.0, 250.0])
_GAMMA_G = np.array([1.21, 1.21, 1.25])
_EPS_G = np.array([1.0, 1.0, 1.0])

# Nonanalytic terms 55-56
_NNA = np.array([-0.14874640856724, 0.31806110878444])
_A_NA = np.array([3.5, 3.5])
_B_NA = np.array([0.85, 0.95])
_BB_NA = np.array([0.2, 0.2])
_CC_NA = np.array([28.0, 32.0])
_DD_NA = np.array([700.0, 800.0])
_AA_NA = np.array([0.32, 0.32])
_BETA_NA = np.array([0.3, 0.3])

_COEF_NAMES = ("N0", "N0E", "G0E", "C", "D", "T", "N", "NG", "DG", "TG", "ALPHA",
               "BETA_G", "GAMMA_G", "EPS_G", "NNA", "A_NA", "B_NA", "BB_NA",
               "CC_NA", "DD_NA", "AA_NA", "BETA_NA")
_NP_COEF = SimpleNamespace(
    **{k: globals()["_" + k] for k in _COEF_NAMES}, CPOS=_C > 0, xp=np)
_TORCH_COEF = {}


def _coef(like):
    """The coefficient tables in ``like``'s array type (numpy, or float64
    tensors on ``like``'s device, built once per device)."""
    if not isinstance(like, torch.Tensor):
        return _NP_COEF
    dev = like.device
    c = _TORCH_COEF.get(dev)
    if c is None:
        c = SimpleNamespace(
            **{k: torch.as_tensor(globals()["_" + k], dtype=torch.float64, device=dev)
               for k in _COEF_NAMES},
            CPOS=torch.as_tensor(_C > 0, device=dev), xp=torch)
        _TORCH_COEF[dev] = c
    return c


def _as_tensor(x) -> torch.Tensor:
    """Tensors pass through; numbers and numpy arrays become float64 CPU
    tensors."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _pair(delta, tau):
    delta, tau = _as_tensor(delta), _as_tensor(tau)
    if delta.device != tau.device:
        # a number or host array meets a device tensor: follow the device
        if tau.ndim == 0 and tau.device.type == "cpu":
            tau = tau.to(delta.device)
        else:
            delta = delta.to(tau.device)
    return delta, tau


# ----------------------------------------------------------------------
# Helmholtz fields and their partials, one closed-form pass
# ----------------------------------------------------------------------

def _phi0_parts(delta, tau, c, order):
    """``phi0`` and its tau partials (``phi0_d`` is 1/delta)."""
    xp = c.xp
    em1 = xp.expm1(-c.G0E * tau[..., None])
    out = {"phi0": xp.log(delta) + c.N0[0] + c.N0[1] * tau + c.N0[2] * xp.log(tau)
           + (c.N0E * xp.log(-em1)).sum(-1)}
    # d/dtau log(-expm1(-g tau)) = g (expm1 + 1) / (-expm1)
    out["phi0_t"] = c.N0[1] + c.N0[2] / tau + (c.N0E * c.G0E * (em1 + 1.0) / (-em1)).sum(-1)
    if order > 1:
        out["phi0_tt"] = (-c.N0[2] / tau ** 2
                          - (c.N0E * c.G0E ** 2 * (em1 + 1.0) / em1 ** 2).sum(-1))
    return out


def _phir_parts(delta, tau, c, order):
    """``phir`` with its first (``order`` 1) or first and second
    (``order`` 2) partials in delta and tau: the sums over the 56 terms."""
    xp = c.xp
    d = delta[..., None]
    t = tau[..., None]

    # terms 1..51: n d^di t^ti exp(-d^ci) (c = 0 -> no exponential)
    dc = xp.where(c.CPOS, d ** c.C, 0.0)
    term = c.N * d ** c.D * t ** c.T * xp.where(c.CPOS, xp.exp(-dc), 1.0)
    kd = c.D - c.C * dc                     # d * (d/dd log term)
    out = {"phir": term.sum(-1),
           "phir_d": (term * kd / d).sum(-1),
           "phir_t": (term * c.T / t).sum(-1)}
    if order > 1:
        out["phir_dd"] = (term * (kd * (kd - 1.0) - c.C ** 2 * dc) / d ** 2).sum(-1)
        out["phir_tt"] = (term * c.T * (c.T - 1.0) / t ** 2).sum(-1)
        out["phir_dt"] = (term * kd * c.T / (d * t)).sum(-1)

    # Gaussian terms 52..54: g (log-derivatives ld, lt)
    g = (c.NG * d ** c.DG * t ** c.TG
         * xp.exp(-c.ALPHA * (d - c.EPS_G) ** 2 - c.BETA_G * (t - c.GAMMA_G) ** 2))
    ld = c.DG / d - 2.0 * c.ALPHA * (d - c.EPS_G)
    lt = c.TG / t - 2.0 * c.BETA_G * (t - c.GAMMA_G)
    out["phir"] = out["phir"] + g.sum(-1)
    out["phir_d"] = out["phir_d"] + (g * ld).sum(-1)
    out["phir_t"] = out["phir_t"] + (g * lt).sum(-1)
    if order > 1:
        out["phir_dd"] = out["phir_dd"] + (g * (ld ** 2 - c.DG / d ** 2 - 2.0 * c.ALPHA)).sum(-1)
        out["phir_tt"] = out["phir_tt"] + (g * (lt ** 2 - c.TG / t ** 2 - 2.0 * c.BETA_G)).sum(-1)
        out["phir_dt"] = out["phir_dt"] + (g * ld * lt).sum(-1)

    # nonanalytic terms 55..56 (guarded so derivatives stay finite at d = 1)
    q = (d - 1.0) ** 2 + 1e-30
    q_d = 2.0 * (d - 1.0)
    pe = 1.0 / (2.0 * c.BETA_NA)
    theta = (1.0 - t) + c.AA_NA * q ** pe
    th_d = c.AA_NA * pe * q ** (pe - 1.0) * q_d
    Delta = theta ** 2 + c.BB_NA * q ** c.A_NA + 1e-30
    De_d = 2.0 * theta * th_d + c.BB_NA * c.A_NA * q ** (c.A_NA - 1.0) * q_d
    De_t = -2.0 * theta
    psi = xp.exp(-c.CC_NA * (d - 1.0) ** 2 - c.DD_NA * (t - 1.0) ** 2)
    ps_d = -2.0 * c.CC_NA * (d - 1.0) * psi
    ps_t = -2.0 * c.DD_NA * (t - 1.0) * psi
    b = c.B_NA
    F = Delta ** b
    F_d = b * Delta ** (b - 1.0) * De_d
    F_t = b * Delta ** (b - 1.0) * De_t
    out["phir"] = out["phir"] + (c.NNA * F * d * psi).sum(-1)
    out["phir_d"] = out["phir_d"] + (c.NNA * (F_d * d * psi + F * psi + F * d * ps_d)).sum(-1)
    out["phir_t"] = out["phir_t"] + (c.NNA * d * (F_t * psi + F * ps_t)).sum(-1)
    if order > 1:
        th_dd = c.AA_NA * pe * ((pe - 1.0) * q ** (pe - 2.0) * q_d ** 2 + 2.0 * q ** (pe - 1.0))
        De_dd = (2.0 * th_d ** 2 + 2.0 * theta * th_dd + c.BB_NA * c.A_NA
                 * ((c.A_NA - 1.0) * q ** (c.A_NA - 2.0) * q_d ** 2 + 2.0 * q ** (c.A_NA - 1.0)))
        De_dt = -2.0 * th_d
        Fb1, Fb2 = Delta ** (b - 1.0), Delta ** (b - 2.0)
        F_dd = b * ((b - 1.0) * Fb2 * De_d ** 2 + Fb1 * De_dd)
        F_tt = b * ((b - 1.0) * Fb2 * De_t ** 2 + Fb1 * 2.0)
        F_dt = b * ((b - 1.0) * Fb2 * De_d * De_t + Fb1 * De_dt)
        ps_dd = (4.0 * c.CC_NA ** 2 * (d - 1.0) ** 2 - 2.0 * c.CC_NA) * psi
        ps_tt = (4.0 * c.DD_NA ** 2 * (t - 1.0) ** 2 - 2.0 * c.DD_NA) * psi
        ps_dt = -2.0 * c.CC_NA * (d - 1.0) * ps_t
        out["phir_dd"] = out["phir_dd"] + (c.NNA * (
            F_dd * d * psi + 2.0 * F_d * psi + 2.0 * F_d * d * ps_d
            + 2.0 * F * ps_d + F * d * ps_dd)).sum(-1)
        out["phir_tt"] = out["phir_tt"] + (c.NNA * d * (
            F_tt * psi + 2.0 * F_t * ps_t + F * ps_tt)).sum(-1)
        out["phir_dt"] = out["phir_dt"] + (c.NNA * (
            F_dt * d * psi + F_d * d * ps_t + F_t * psi + F * ps_t
            + F_t * d * ps_d + F * d * ps_dt)).sum(-1)
    return out


def _fields(delta, tau, order=1):
    c = _coef(delta)
    out = _phir_parts(delta, tau, c, order)
    out.update(_phi0_parts(delta, tau, c, order))
    return out


def phi0(delta, tau):
    """Ideal-gas part of the dimensionless Helmholtz energy."""
    delta, tau = _pair(delta, tau)
    return _phi0_parts(delta, tau, _coef(delta), 1)["phi0"]


def phir(delta, tau):
    """Residual part of the dimensionless Helmholtz energy (56 terms)."""
    delta, tau = _pair(delta, tau)
    return _phir_parts(delta, tau, _coef(delta), 1)["phir"]


def phir_d(delta, tau):
    delta, tau = _pair(delta, tau)
    return _phir_parts(delta, tau, _coef(delta), 1)["phir_d"]


def phir_t(delta, tau):
    delta, tau = _pair(delta, tau)
    return _phir_parts(delta, tau, _coef(delta), 1)["phir_t"]


def phi0_t(delta, tau):
    delta, tau = _pair(delta, tau)
    return _phi0_parts(delta, tau, _coef(delta), 1)["phi0_t"]


def phir_second(delta, tau):
    """``(phir_dd, phir_tt, phir_dt)``: the residual part's second
    partials."""
    delta, tau = _pair(delta, tau)
    f = _phir_parts(delta, tau, _coef(delta), 2)
    return f["phir_dd"], f["phir_tt"], f["phir_dt"]


def phi0_tt(delta, tau):
    delta, tau = _pair(delta, tau)
    return _phi0_parts(delta, tau, _coef(delta), 2)["phi0_tt"]


# ----------------------------------------------------------------------
# Properties on (delta, T) — molar SI
# ----------------------------------------------------------------------
# Each takes the fields of one closed-form pass; the public functions
# run on tensors, the host solvers below on numpy.


def _p(delta, T, f):
    return delta * RHOC * R_MASS * T * (1.0 + delta * f["phir_d"])


def _h(delta, T, f):
    tau = TC / T
    return R_MOL * T * (1.0 + tau * (f["phi0_t"] + f["phir_t"]) + delta * f["phir_d"])


def _s(delta, T, f):
    tau = TC / T
    return R_MOL * (tau * (f["phi0_t"] + f["phir_t"]) - f["phi0"] - f["phir"])


def _g(delta, T, f):
    return R_MOL * T * (1.0 + f["phi0"] + f["phir"] + delta * f["phir_d"])


def _on(delta, T):
    delta, T = _pair(delta, T)
    return delta, T, TC / T


def p_dT(delta, T):
    """Pressure [Pa] from reduced density and temperature."""
    delta, T, tau = _on(delta, T)
    return _p(delta, T, _fields(delta, tau))


def h_dT(delta, T):
    """Molar enthalpy [J/mol]."""
    delta, T, tau = _on(delta, T)
    return _h(delta, T, _fields(delta, tau))


def s_dT(delta, T):
    """Molar entropy [J/mol/K]."""
    delta, T, tau = _on(delta, T)
    return _s(delta, T, _fields(delta, tau))


def u_dT(delta, T):
    """Molar internal energy [J/mol]."""
    delta, T, tau = _on(delta, T)
    f = _fields(delta, tau)
    return R_MOL * T * tau * (f["phi0_t"] + f["phir_t"])


def g_dT(delta, T):
    """Molar Gibbs energy [J/mol] (phase-equilibrium residuals)."""
    delta, T, tau = _on(delta, T)
    return _g(delta, T, _fields(delta, tau))


def _cv(tau, f):
    return -R_MOL * tau ** 2 * (f["phi0_tt"] + f["phir_tt"])


def cv_dT(delta, T):
    """Isochoric molar heat capacity [J/mol/K]."""
    delta, T, tau = _on(delta, T)
    return _cv(tau, _fields(delta, tau, 2))


def cp_dT(delta, T):
    """Isobaric molar heat capacity [J/mol/K]."""
    delta, T, tau = _on(delta, T)
    f = _fields(delta, tau, 2)
    num = (1.0 + delta * f["phir_d"] - delta * tau * f["phir_dt"]) ** 2
    den = 1.0 + 2.0 * delta * f["phir_d"] + delta ** 2 * f["phir_dd"]
    return _cv(tau, f) + R_MOL * num / den


def w_dT(delta, T):
    """Speed of sound [m/s] (mass basis; validation only)."""
    delta, T, tau = _on(delta, T)
    f = _fields(delta, tau, 2)
    pd = f["phir_d"]
    w2 = R_MASS * T * (
        1.0 + 2.0 * delta * pd + delta ** 2 * f["phir_dd"]
        - (1.0 + delta * pd - delta * tau * f["phir_dt"]) ** 2
        / (tau ** 2 * (f["phi0_tt"] + f["phir_tt"])))
    return torch.sqrt(w2)


# ----------------------------------------------------------------------
# Wagner-Pruss auxiliary saturation equations (explicit; initial guesses)
# ----------------------------------------------------------------------

_PS_A = np.array([-7.85951783, 1.84408259, -11.7866497,
                  22.6807411, -15.9618719, 1.80122502])
_RL_B = np.array([1.99274064, 1.09965342, -0.510839303,
                  -1.75493479, -45.5170352, -6.74694450e5])
_RV_C = np.array([-2.03150240, -2.68302940, -5.38626492,
                  -17.2991605, -44.7586581, -63.9201063])


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else np


def sat_p_aux(T):
    """Saturation pressure [Pa], explicit auxiliary equation (tensor in,
    tensor out; numpy in, numpy out)."""
    xp = _xp(T)
    T = T if xp is torch else np.asarray(T, dtype=np.float64)
    th = 1.0 - T / TC
    poly = (_PS_A[0] * th + _PS_A[1] * th ** 1.5 + _PS_A[2] * th ** 3
            + _PS_A[3] * th ** 3.5 + _PS_A[4] * th ** 4 + _PS_A[5] * th ** 7.5)
    return PC * xp.exp(TC / T * poly)


def sat_rhol_aux(T):
    """Saturated-liquid density [kg/m^3], explicit auxiliary equation."""
    T = T if isinstance(T, torch.Tensor) else np.asarray(T, dtype=np.float64)
    th = 1.0 - T / TC
    b = (1.0 + _RL_B[0] * th ** (1 / 3) + _RL_B[1] * th ** (2 / 3)
         + _RL_B[2] * th ** (5 / 3) + _RL_B[3] * th ** (16 / 3)
         + _RL_B[4] * th ** (43 / 3) + _RL_B[5] * th ** (110 / 3))
    return RHOC * b


def sat_rhov_aux(T):
    """Saturated-vapor density [kg/m^3], explicit auxiliary equation."""
    xp = _xp(T)
    T = T if xp is torch else np.asarray(T, dtype=np.float64)
    th = 1.0 - T / TC
    c = (_RV_C[0] * th ** (2 / 6) + _RV_C[1] * th ** (4 / 6)
         + _RV_C[2] * th ** (8 / 6) + _RV_C[3] * th ** (18 / 6)
         + _RV_C[4] * th ** (37 / 6) + _RV_C[5] * th ** (71 / 6))
    return RHOC * xp.exp(c)


# ----------------------------------------------------------------------
# Host-side solvers (float64 numpy scalars/arrays; initialization only)
# ----------------------------------------------------------------------

def _np(x):
    return np.asarray(x, dtype=np.float64)


def _host_fields(d, T, order=1):
    d, T = _np(d), _np(T)
    return d, T, _fields(d, TC / T, order)


def _h_host(d, T):
    d, T, f = _host_fields(d, T)
    return _h(d, T, f)


def _s_host(d, T):
    d, T, f = _host_fields(d, T)
    return _s(d, T, f)


def _p_dp(d, T, f=None):
    """Pressure and its delta-derivative at (d, T)."""
    if f is None:
        d, T, f = _host_fields(d, T, 2)
    dp = RHOC * R_MASS * T * (1.0 + 2.0 * d * f["phir_d"] + d ** 2 * f["phir_dd"])
    return _p(d, T, f), dp


def _g_dg(d, T, f):
    """Gibbs energy and its delta-derivative at (d, T)."""
    dg = R_MOL * T * (1.0 / d + 2.0 * f["phir_d"] + d * f["phir_dd"])
    return _g(d, T, f), dg


def sat_solve_T(T):
    """Maxwell-polished saturation state at temperature T [K].

    Returns (p_sat [Pa], delta_l, delta_v).  Newton on
    [p(dl) - p(dv), g(dl) - g(dv)] from the auxiliary-equation guesses.
    """
    T = _np(T)
    dl = _np(sat_rhol_aux(T)) / RHOC
    dv = _np(sat_rhov_aux(T)) / RHOC
    for _ in range(30):
        # both phases in one closed-form pass
        d2, T2, f = _host_fields(np.stack([dl, dv]), T, 2)
        (pl, pv), (dpl, dpv) = _p_dp(d2, T2, f)
        (gl, gv), (dgl, dgv) = _g_dg(d2, T2, f)
        f1 = pl - pv
        f2 = (gl - gv) / R_MOL / T
        dgl = dgl / R_MOL / T
        dgv = dgv / R_MOL / T
        det = dpl * (-dgv) - (-dpv) * dgl
        det = np.where(np.abs(det) < 1e-300, 1e-300, det)
        ddl = (f1 * (-dgv) - (-dpv) * f2) / det
        ddv = (dpl * f2 - dgl * f1) / det
        dl = np.clip(dl - ddl, 1e-8, 4.2)
        dv = np.clip(dv - ddv, 1e-10, 1.05)
        if np.all(np.abs(f1) < 1e-6) and np.all(np.abs(f2) < 1e-12):
            break
    return _p_dp(dl, T)[0], dl, dv


def sat_solve_P(P):
    """Saturation state at pressure P [Pa]: returns (T_sat, delta_l, delta_v)."""
    P = _np(P)
    # invert the auxiliary ps(T) by bisection for the T guess
    lo = np.full(np.shape(P), 273.16)
    hi = np.full(np.shape(P), TC - 1e-6)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lowr = sat_p_aux(mid) < P
        lo = np.where(lowr, mid, lo)
        hi = np.where(lowr, hi, mid)
    T = 0.5 * (lo + hi)
    # polish with the Maxwell solve + 1D secant on p_sat(T) - P
    for _ in range(12):
        ps, dl, dv = sat_solve_T(T)
        err = ps - P
        dT = 0.01
        ps2, _, _ = sat_solve_T(T + dT)
        dpdT = (ps2 - ps) / dT
        T = T - err / np.where(np.abs(dpdT) < 1e-300, 1e-300, dpdT)
        if np.all(np.abs(err) < 1e-7 * P):
            break
    ps, dl, dv = sat_solve_T(T)
    return T, dl, dv


def rho_tp(T, P, phase):
    """Density [kg/m^3] at (T, P) by host Newton on the pressure.

    ``phase``: 'liq' or 'vap' selects the branch via the initial guess
    (liquid-like vs ideal-gas-like); supercritical states accept either.
    """
    T = _np(T)
    P = _np(P)
    shape = np.broadcast_shapes(T.shape, P.shape)
    if phase == "liq":
        d = np.broadcast_to(
            np.where(T < TC, _np(sat_rhol_aux(np.minimum(T, TC - 1e-3))) / RHOC, 1.8),
            shape).copy()
        d = np.maximum(d, 1.0)
    else:
        d = np.broadcast_to(P / (R_MASS * T * RHOC), shape).copy()
        d = np.minimum(d, 0.9)
    for _ in range(80):
        pv, dpv = _p_dp(d, T)
        f = pv - P
        df = np.where(np.abs(dpv) < 1e-300, 1e-300, dpv)
        step = f / df
        # keep Newton on the declared branch
        dn = d - np.clip(step, -0.25 * np.maximum(d, 0.05), 0.25 * np.maximum(d, 0.05))
        d = np.clip(dn, 1e-10, 4.2)
        if np.all(np.abs(f) < 1e-7 * np.maximum(P, 1.0)):
            break
    return d * RHOC


def props_tp(T, P, phase):
    """dict of molar properties at single-phase (T, P) (host numpy)."""
    d = rho_tp(T, P, phase) / RHOC
    d, T, f = _host_fields(d, T)
    return {"delta": d, "rho": d * RHOC, "h": _h(d, T, f), "s": _s(d, T, f),
            "g": _g(d, T, f)}


def flash_hp(h, P):
    """Host flash at (molar enthalpy, pressure).

    Returns dict with T, x (vapor fraction), delta_l, delta_v, s and a
    phase tag.
    """
    h = _np(h)
    P = _np(P)
    scalar = h.ndim == 0 and P.ndim == 0
    h = np.atleast_1d(h)
    P = np.atleast_1d(P)
    out = {k: np.zeros(np.broadcast_shapes(h.shape, P.shape))
           for k in ("T", "x", "delta_l", "delta_v", "s")}
    phase = np.empty(out["T"].shape, dtype=object)
    h, P = np.broadcast_arrays(h, P)
    for i in np.ndindex(h.shape):
        hi, Pi = float(h[i]), float(P[i])
        if Pi < PC:
            Ts, dl, dv = sat_solve_P(Pi)
            hl = float(_h_host(dl, Ts))
            hv = float(_h_host(dv, Ts))
            if hl <= hi <= hv:
                x = (hi - hl) / (hv - hl)
                sl = float(_s_host(dl, Ts))
                sv = float(_s_host(dv, Ts))
                out["T"][i] = Ts
                out["x"][i] = x
                out["delta_l"][i] = dl
                out["delta_v"][i] = dv
                out["s"][i] = (1 - x) * sl + x * sv
                phase[i] = "two-phase"
                continue
            br = "liq" if hi < hl else "vap"
        else:
            # supercritical: pick the branch by enthalpy vs a mid guess
            br = "liq" if hi < 25000.0 else "vap"
        # 1D Newton on T with the rho_tp inner solve
        T = _guess_T_hp(hi, Pi, br)
        for _ in range(60):
            d = rho_tp(T, Pi, br) / RHOC
            f = float(_h_host(d, T)) - hi
            dT = max(1e-3, 1e-6 * T)
            d2 = rho_tp(T + dT, Pi, br) / RHOC
            df = (float(_h_host(d2, T + dT)) - hi - f) / dT
            if df == 0:
                break
            T = float(np.clip(T - f / df, 254.0, 1400.0))
            if abs(f) < 1e-7 * max(abs(hi), 1.0):
                break
        d = rho_tp(T, Pi, br) / RHOC
        out["T"][i] = T
        out["x"][i] = 0.0 if br == "liq" else 1.0
        out["delta_l"][i] = d if br == "liq" else 0.0
        out["delta_v"][i] = d if br == "vap" else 0.0
        out["s"][i] = float(_s_host(d, T))
        phase[i] = br
    out["phase"] = phase
    if scalar:
        out = {k: (v[0] if isinstance(v, np.ndarray) else v[(0,)]) for k, v in out.items()}
    return out


def _guess_T_hp(h, P, phase):
    if phase == "liq":
        # liquid enthalpy roughly cp ~ 75.3 J/mol/K from 273 K
        return float(np.clip(273.15 + h / 75.3, 260.0, 640.0))
    # vapor: ideal-gas-like estimate
    return float(np.clip((h - 40000.0) / 36.0 + 500.0, 280.0, 1350.0))


def h_ps(P, s, phase):
    """Host inverse: molar enthalpy at (P, s) on a declared branch, with
    two-phase handling below the dome (isentropic-expansion warm starts).
    """
    P = float(P)
    s = float(s)
    if P < PC:
        Ts, dl, dv = sat_solve_P(P)
        sl = float(_s_host(dl, Ts))
        sv = float(_s_host(dv, Ts))
        if sl <= s <= sv:
            x = (s - sl) / (sv - sl)
            hl = float(_h_host(dl, Ts))
            hv = float(_h_host(dv, Ts))
            return (1 - x) * hl + x * hv
        branch = "liq" if s < sl else "vap"
    else:
        branch = phase
    # Newton on T: s(T, P) = s
    T = 300.0 if branch == "liq" else 600.0
    for _ in range(80):
        d = rho_tp(T, P, branch) / RHOC
        f = float(_s_host(d, T)) - s
        dT = max(1e-3, 1e-6 * T)
        d2 = rho_tp(T + dT, P, branch) / RHOC
        df = (float(_s_host(d2, T + dT)) - s - f) / dT
        if df == 0:
            break
        T = float(np.clip(T - f / df, 254.0, 1400.0))
        if abs(f) < 1e-10 * max(abs(s), 1.0):
            break
    d = rho_tp(T, P, branch) / RHOC
    return float(_h_host(d, T))
