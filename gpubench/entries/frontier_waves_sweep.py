"""A whole L-grid in one call through the frontier model's wave-parallel
sweep (``models/frontier.py::frontier_waves_sweep``): the waves=8 route
that ``solve_qp_batch_auto``'s rule picks at B=8192, then every point's rows
restored in float64."""


def run(p, req, settings):
    from ssqp_tpu_torch.models.frontier import frontier_waves_sweep

    return frontier_waves_sweep(p.qp, p.rets, req["lams"], settings,
                                waves=8)


def view(p, req, out) -> dict:
    return dict(x=out.x, S=out.S, status=out.status, ret=out.ret,
                risk=out.risk)
