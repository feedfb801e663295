"""MPS file import and export (PyTorch).

Counterpart of ``ssqp_tpu/utils/mps.py``, the reference's file-based
workflow (examples/rwMOI.jl:1-10: ``read_from_file`` then ``optimize!``).
Free-format MPS (fixed-format files parse too: the free grammar is a
superset for the common subset) is parsed into a
:class:`ssqp_tpu_torch.model.Model`, which assembles the LP or QP on its
device and dispatches the right engine. The parser and writer are plain
Python and numpy, the same text in and out as the JAX package's.

Supported sections: NAME, OBJSENSE, ROWS (N/L/G/E), COLUMNS (with integer
markers tolerated-but-relaxed), RHS, RANGES, BOUNDS (UP LO FX FR MI PL BV),
QUADOBJ/QMATRIX (quadratic objective, lower-triangle entries; QMATRIX gives
both triangles), ENDATA. Unsupported sections raise ValueError rather than
silently mis-reading (SOS, indicators).
"""

from __future__ import annotations

import io

import numpy as np


def _tok(line: str):
    return line.split()


def read_mps(source, relax_integers: bool = False, *, dtype=None,
             device="cuda") -> "Model":
    """Parse MPS text into a ready-to-optimize Model, built on ``device``
    (the card unless the caller says otherwise) in ``dtype`` (the Model's
    default, float32, unless given).

    ``source`` is a path (gzip-compressed ``.mps.gz`` files are read
    transparently — the reference's file workflow reads grow7.mps.gz,
    rwMOI.jl:6), a file object, raw MPS text, or raw (optionally gzipped)
    bytes.

    ``relax_integers``: integer markers (INTORG/INTEND) are a hard error by
    default — the engines are LP/QP only, and silently solving a MIP's
    continuous relaxation would report OPTIMAL for the wrong problem class.
    Pass True to opt into the relaxation; the returned Model then carries
    ``relaxed_integers=True`` so status consumers can tell.
    """
    from ssqp_tpu_torch.model import Model

    import gzip
    import os

    m = Model(dtype=dtype, device=device)  # raises early without the device

    _GZ_MAGIC = b"\x1f\x8b"
    if hasattr(source, "read"):
        text = source.read()
        if isinstance(text, bytes):
            if text[:2] == _GZ_MAGIC:
                text = gzip.decompress(text)
            text = text.decode()
    elif isinstance(source, bytes):
        text = source
        if text[:2] == _GZ_MAGIC:
            text = gzip.decompress(text)
        text = text.decode()
    elif isinstance(source, os.PathLike) or (
        isinstance(source, str) and "\n" not in source
    ):
        path = os.fspath(source)
        if path.endswith(".gz"):
            with gzip.open(path, "rt") as fh:
                text = fh.read()
        else:
            with open(path) as fh:
                text = fh.read()
    else:
        text = source
    relaxed_any = False

    section = None
    obj_row = None
    sense = "min"
    rows = {}  # name -> kind in {'L','G','E'}
    row_order = []
    cols = {}  # var -> {row: coef}
    col_order = []
    obj_coefs = {}
    rhs = {}
    ranges = {}
    bounds = {}  # var -> [lo, up]
    quad = {}  # (var_i, var_j) -> coef
    in_integer = False

    for raw in io.StringIO(text):
        line = raw.rstrip("\n")
        if not line.strip() or line.lstrip().startswith("*"):
            continue
        if not line[0].isspace():  # section header
            parts = _tok(line)
            section = parts[0].upper()
            if section == "NAME":
                continue
            if section == "OBJSENSE":
                # OBJSENSE may carry the value on the same line
                if len(parts) > 1:
                    sense = "max" if parts[1].upper().startswith("MAX") else "min"
                continue
            if section in ("ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS",
                           "QUADOBJ", "QMATRIX", "ENDATA"):
                continue
            raise ValueError(f"unsupported MPS section: {section}")
        parts = _tok(line)
        if section == "OBJSENSE":
            sense = "max" if parts[0].upper().startswith("MAX") else "min"
        elif section == "ROWS":
            kind, name = parts[0].upper(), parts[1]
            if kind == "N":
                if obj_row is None:
                    obj_row = name
                # extra N rows are ignored (standard behavior)
            else:
                if kind not in ("L", "G", "E"):
                    raise ValueError(f"bad row kind {kind}")
                rows[name] = kind
                row_order.append(name)
        elif section == "COLUMNS":
            if len(parts) >= 3 and parts[1].upper() == "'MARKER'":
                if parts[2].upper() == "'INTORG'" and not in_integer:
                    if not relax_integers:
                        raise ValueError(
                            "MPS integer marker: the engines are LP/QP only;"
                            " pass relax_integers=True to solve the"
                            " continuous relaxation (the Model then carries"
                            " relaxed_integers=True)"
                        )
                    import warnings

                    warnings.warn(
                        "MPS integer marker: variables are relaxed to "
                        "continuous (LP/QP engines only)", stacklevel=2,
                    )
                    relaxed_any = True
                in_integer = parts[2].upper() == "'INTORG'"
                continue
            var = parts[0]
            if var not in cols:
                cols[var] = {}
                col_order.append(var)
            for rname, val in zip(parts[1::2], parts[2::2]):
                v = float(val)
                if rname == obj_row:
                    obj_coefs[var] = obj_coefs.get(var, 0.0) + v
                elif rname in rows:
                    cols[var][rname] = cols[var].get(rname, 0.0) + v
                # coefficients for ignored extra N rows are dropped
        elif section == "RHS":
            # first token is the RHS set name (arbitrary)
            for rname, val in zip(parts[1::2], parts[2::2]):
                if rname == obj_row:
                    # objective constant enters negated per MPS convention
                    rhs[obj_row] = float(val)
                else:
                    rhs[rname] = float(val)
        elif section == "RANGES":
            for rname, val in zip(parts[1::2], parts[2::2]):
                ranges[rname] = float(val)
        elif section == "BOUNDS":
            btype = parts[0].upper()
            var = parts[2]
            lo, up = bounds.get(var, [0.0, np.inf])
            if btype == "UP":
                up = float(parts[3])
                if up < 0 and lo == 0.0:
                    # classic MPS quirk: negative UP implies free-below
                    lo = -np.inf
            elif btype == "LO":
                lo = float(parts[3])
            elif btype == "FX":
                lo = up = float(parts[3])
            elif btype == "FR":
                lo, up = -np.inf, np.inf
            elif btype == "MI":
                lo = -np.inf
            elif btype == "PL":
                up = np.inf
            elif btype == "BV":
                raise ValueError("binary variables are not supported")
            else:
                raise ValueError(f"bad bound type {btype}")
            bounds[var] = [lo, up]
        elif section in ("QUADOBJ", "QMATRIX"):
            vi, vj, val = parts[0], parts[1], float(parts[2])
            quad[(vi, vj)] = quad.get((vi, vj), 0.0) + val
        elif section == "ENDATA":
            break
        else:
            raise ValueError(f"data line outside a known section: {line!r}")

    # ---- assemble the Model ------------------------------------------------
    idx = {}
    for var in col_order:
        lo, up = bounds.get(var, [0.0, np.inf])
        idx[var] = m.add_variable(lo, up)
    N = len(col_order)

    for rname in row_order:
        kind = rows[rname]
        coefs = np.zeros(N)
        for var in col_order:
            if rname in cols[var]:
                coefs[idx[var]] = cols[var][rname]
        r = rhs.get(rname, 0.0)
        if rname in ranges:
            rng = ranges[rname]
            # RANGES semantics (standard): row becomes two-sided
            if kind == "L":
                lo_, hi_ = r - abs(rng), r
            elif kind == "G":
                lo_, hi_ = r, r + abs(rng)
            else:  # E
                lo_, hi_ = (r, r + rng) if rng >= 0 else (r + rng, r)
            m.add_interval(coefs, lo_, hi_)
        elif kind == "L":
            m.add_le(coefs, r)
        elif kind == "G":
            m.add_ge(coefs, r)
        else:
            m.add_eq(coefs, r)

    lin = np.zeros(N)
    for var, v in obj_coefs.items():
        lin[idx[var]] = v
    const = -rhs.get(obj_row, 0.0) if obj_row in rhs else 0.0

    if quad:
        V = np.zeros((N, N))
        qmatrix = any((j, i) in quad and i != j for (i, j) in quad)
        for (vi, vj), v in quad.items():
            i, j = idx[vi], idx[vj]
            V[i, j] += v
            if i != j and not qmatrix:
                # QUADOBJ stores one triangle; mirror it
                V[j, i] += v
        V = (V + V.T) / 2
        m.set_objective(quad=V, lin=lin, constant=const, sense=sense)
    else:
        m.set_objective(lin=lin, constant=const, sense=sense)
    m.relaxed_integers = relaxed_any
    return m


def _fmt(x: float) -> str:
    """Shortest exact decimal (Python repr round-trips binary floats)."""
    return repr(float(x))


def write_mps(m, path=None, name: str = "SSQP") -> str:
    """Emit free-format MPS for a :class:`~ssqp_tpu_torch.model.Model` (the
    reference's write side of the MOI file bridge, rwMOI.jl /
    MOIwrapper.jl:380-509 QP2MOI/LP2MOI).

    Round-trip exact: ``read_mps(write_mps(m))`` reassembles the identical
    LP or QP (floats are emitted as shortest-repr decimals, which decode
    to the same binaries; row/column order and interval rows survive through
    RANGES). ``path`` writes to a file — gzip-compressed when it ends in
    ``.gz`` — and the text is returned either way.

    Sections emitted: NAME, OBJSENSE (MAX only), ROWS, COLUMNS, RHS, RANGES
    (interval rows), BOUNDS, QUADOBJ, ENDATA.
    """
    import gzip
    import os

    rows = list(m._rows)
    rname = [f"R{i}" for i in range(len(rows))]
    cname = [f"C{j}" for j in range(m.n)]

    out = [f"NAME          {name}"]
    if m._sense == "max":
        out += ["OBJSENSE", "    MAX"]
    out.append("ROWS")
    out.append(" N  OBJ")
    for i, (kind, _, lo, hi) in enumerate(rows):
        k = {"eq": "E", "le": "L", "ge": "G", "interval": "L"}[kind]
        out.append(f" {k}  {rname[i]}")

    # transpose the row-major coefficient dicts into columns
    by_col = [dict() for _ in range(m.n)]
    for i, (_, coeffs, _, _) in enumerate(rows):
        for j, v in coeffs.items():
            by_col[j][i] = v
    out.append("COLUMNS")
    for j in range(m.n):
        # every variable appears at least once (its objective coefficient,
        # possibly zero) so the reader reconstructs the full column order
        out.append(f"    {cname[j]}  OBJ  {_fmt(m._lin.get(j, 0.0))}")
        for i, v in sorted(by_col[j].items()):
            out.append(f"    {cname[j]}  {rname[i]}  {_fmt(v)}")

    out.append("RHS")
    if m._f0 != 0.0:
        # objective constant enters negated per MPS convention (reader does
        # const = -rhs[obj_row])
        out.append(f"    RHS1  OBJ  {_fmt(-m._f0)}")
    for i, (kind, _, lo, hi) in enumerate(rows):
        r = hi if kind in ("le", "interval") else lo
        if r != 0.0:
            out.append(f"    RHS1  {rname[i]}  {_fmt(r)}")
    ranged = [(i, lo, hi) for i, (k, _, lo, hi) in enumerate(rows)
              if k == "interval"]
    if ranged:
        out.append("RANGES")
        for i, lo, hi in ranged:
            # kind L with rhs=hi and range=hi-lo reads back as [lo, hi]
            out.append(f"    RNG1  {rname[i]}  {_fmt(hi - lo)}")

    blines = []
    for j in range(m.n):
        lo, up = m._lb[j], m._ub[j]
        if lo == 0.0 and up == np.inf:
            continue  # the MPS default bound
        if lo == up:
            blines.append(f" FX BND1  {cname[j]}  {_fmt(lo)}")
        elif lo == -np.inf and up == np.inf:
            blines.append(f" FR BND1  {cname[j]}")
        else:
            if np.isfinite(up):
                blines.append(f" UP BND1  {cname[j]}  {_fmt(up)}")
            if lo == -np.inf:
                blines.append(f" MI BND1  {cname[j]}")
            elif lo != 0.0 or up < 0:
                # explicit LO also defuses the classic negative-UP quirk
                # (UP < 0 with default lo implies free-below on read);
                # emitted AFTER UP so the reader's quirk branch never fires
                blines.append(f" LO BND1  {cname[j]}  {_fmt(lo)}")
    if blines:
        out.append("BOUNDS")
        out.extend(blines)

    if m._quad:
        # emit the symmetrized x'Vx matrix's lower triangle; the reader
        # mirrors single-triangle QUADOBJ entries back to full symmetry
        S: dict = {}
        for (i, j), v in m._quad.items():
            a, b = (i, j) if i >= j else (j, i)
            S[(a, b)] = S.get((a, b), 0.0) + (v if i == j else v / 2.0)
        quad_lines = [
            f"    {cname[i]}  {cname[j]}  {_fmt(v)}"
            for (i, j), v in sorted(S.items()) if v != 0.0
        ]
        if quad_lines:
            out.append("QUADOBJ")
            out.extend(quad_lines)

    out.append("ENDATA")
    text = "\n".join(out) + "\n"
    if path is not None:
        path = os.fspath(path)
        if path.endswith(".gz"):
            with gzip.open(path, "wt") as fh:
                fh.write(text)
        else:
            with open(path, "w") as fh:
                fh.write(text)
    return text


def solve_mps(source, settings=None, relax_integers: bool = False, *,
              dtype=None, device="cuda"):
    """Convenience: read + optimize; returns the Model (reference rwMOI.jl
    workflow: read_from_file -> optimize! -> inspect). ``settings`` override
    the Model's solver settings FOR THIS SOLVE ONLY (the Model's own settings
    are restored afterwards)."""
    m = read_mps(source, relax_integers=relax_integers, dtype=dtype,
                 device=device)
    if settings is not None:
        prior = m.settings
        m.settings = settings
        try:
            m.optimize()
        finally:
            m.settings = prior
    else:
        m.optimize()
    return m
