"""K1, the Newton-Schulz kernel (``ns_invsqrt_kernel``): the least time the
card could take for the launches of the traced steps, their operations
counted from each matrix's own step count, over the kernel's time in the
profiler's record."""

KERNEL = "ns_invsqrt_kernel"


def install(ctx):
    from cwbnwp_letkf_torch.ops import ns_kernel

    launch = ns_kernel.launch
    seen = ctx.data.setdefault(KERNEL, [])

    def counted(a_obs, inflat, **kwargs):
        z, iters, resid = launch(a_obs, inflat, **kwargs)
        seen.append((a_obs.shape[0], a_obs.shape[1], iters.sum()))
        return z, iters, resid

    return [(ns_kernel, "launch", counted)]


def read(ctx):
    from letkf_bench.roofline import least_seconds, ns_invsqrt_work

    kernel_s = sum(s for n, s in ctx.trace.kernel_s.items() if KERNEL in n)
    seen = ctx.data.get(KERNEL, [])
    if not seen or not kernel_s:
        return None
    flop = nbytes = 0.0
    for b, k, steps in seen:
        f, n = ns_invsqrt_work(b, k, float(steps))
        flop += f
        nbytes += n
    return 100.0 * least_seconds(flop, nbytes) / kernel_s
