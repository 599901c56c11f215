"""Offline analysis tools as one command line (port of
barcode_tpu/tools/__main__.py):

    python -m barcode_tpu_torch.tools <tool> [args...] [--device cuda|cpu]

tools: powspec, corr_fct, 2D_powspec, 2D_corr_fct, lag2eul, density,
interp_upres, poisson_upres.  Each runs on the CUDA card unless
`--device cpu` is given, and raises without a card (device.resolve).
`poisson_upres` is host numpy, as in the JAX package: its per-particle
expansion has a data-dependent size.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

STATISTICS = ("powspec", "corr_fct", "2D_powspec", "2D_corr_fct")


def _grid_arg(p):
    p.add_argument("fname_in", help="input grid file (without .dat)")
    p.add_argument("N", type=int, help="cells per axis")
    p.add_argument("L", type=float, help="box size [Mpc/h]")


def _device_arg(p):
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (default: the CUDA card; raises "
                        "without one)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="barcode_tpu_torch.tools")
    sub = p.add_subparsers(dest="tool", required=True)

    for name in STATISTICS:
        sp = sub.add_parser(name)
        _grid_arg(sp)
        sp.add_argument("--nbin", type=int, default=200)
        sp.add_argument("--out", default=None)
        sp.add_argument("--fft-upsample", type=int, default=1,
                        help="band-limited zero-pad upsampling factor before "
                             "measuring (2D_corr_fct_interp's interp_mode=1)")
        sp.add_argument("--cic-upsample", type=int, default=1,
                        help="CIC-interpolate onto an N*factor grid before "
                             "measuring (2D_corr_fct_interp's interp_mode=0, "
                             "interp_field: gather at output cell centers)")
        _device_arg(sp)

    sp = sub.add_parser("lag2eul", help="delta_lag grid -> delta_eul (LAG2EULer)")
    _grid_arg(sp)
    sp.add_argument("--sfmodel", type=int, default=1)
    sp.add_argument("--masskernel", default="sph_ft")
    sp.add_argument("--z", type=float, default=0.0)
    sp.add_argument("--slength", type=float, default=4.0)
    sp.add_argument("--transf-zeld", default=None,
                    help="TRANSF build: auxtransfzeld kernel grid (.dat, full "
                         "N^3 layout) convolved into the linear field "
                         "(Lag2Eul.cc:174-191)")
    sp.add_argument("--transf-2lpt", default=None,
                    help="TRANSF build: auxtransf2lpt kernel for the 2LPT source")
    sp.add_argument("--out", default=None)
    _device_arg(sp)

    sp = sub.add_parser("density", help="x,y,z particle files -> SPH density grid")
    sp.add_argument("fname_base", help="base name; reads <base>_x/_y/_z.dat")
    sp.add_argument("N", type=int)
    sp.add_argument("L", type=float)
    sp.add_argument("--kernel-h", type=float, default=None)
    sp.add_argument("--out", default=None)
    _device_arg(sp)

    sp = sub.add_parser("interp_upres", help="CIC upsample a grid")
    _grid_arg(sp)
    sp.add_argument("N_out", type=int)
    sp.add_argument("--out", default=None)
    _device_arg(sp)

    sp = sub.add_parser("poisson_upres",
                        help="Poisson-sample a density grid to higher-res particles")
    _grid_arg(sp)
    sp.add_argument("N_out", type=int)
    sp.add_argument("Nbar", type=float, help="mean particles per output cell")
    sp.add_argument("--seed", type=int, default=1)
    sp.add_argument("--out", default=None)
    _device_arg(sp)
    return p.parse_args(argv)


def main(argv=None):
    return run_tool(parse_args(argv))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def run_tool(args):
    from barcode_tpu_torch import device as device_mod, io as bio
    from barcode_tpu_torch.grid.spec import GridSpec

    dev = device_mod.resolve(args.device)
    tool = args.tool

    def read_grid(fname, g):
        return torch.from_numpy(bio.read_array(fname, g.shape)).to(dev)

    if tool in STATISTICS:
        from barcode_tpu_torch import statistics
        from barcode_tpu_torch.forward import assign, particles
        from barcode_tpu_torch.grid import fourier

        g = GridSpec.cube(args.N, args.L)
        x = read_grid(args.fname_in, g)
        if args.fft_upsample > 1 and args.cic_upsample > 1:
            raise SystemExit("choose one of --fft-upsample / --cic-upsample")
        if args.fft_upsample > 1:
            x = fourier.fft_upsample(x, g, args.fft_upsample)
            g = GridSpec.cube(args.N * args.fft_upsample, args.L)
        elif args.cic_upsample > 1:
            # interp_mode=0 of 2D_corr_fct_interp (interp_field,
            # tools/2D_corr_fct_interp.cc:35-63): CIC-gather the input at
            # the upsampled grid's cell centers, then measure
            g_out = GridSpec.cube(args.N * args.cic_upsample, args.L)
            pos_out = particles.lagrangian_positions(g_out, device=dev)
            x = assign.cic_gather(x, pos_out, g)
            del pos_out
            g = g_out
        out = args.out or f"{args.fname_in}_{tool}"
        if tool == "powspec":
            km, pw, _ = fourier.measure_spectrum(x, g, args.nbin)
            bio.dump_spectrum(out + ".dat", _host(km), _host(pw))
        elif tool == "corr_fct":
            rm, corr, _ = statistics.measure_correlation(x, g, args.nbin)
            bio.dump_spectrum(out + ".dat", _host(rm), _host(corr))
        elif tool == "2D_powspec":
            _, pw, _ = statistics.measure_spectrum_2d(x, g, args.nbin)
            bio.write_array(out, _host(pw))
        else:
            _, corr, _ = statistics.measure_correlation_2d(x, g, args.nbin)
            bio.write_array(out, _host(corr))
        print(f"wrote {out}.dat")
        return 0

    if tool == "lag2eul":
        from barcode_tpu_torch import cosmo
        from barcode_tpu_torch.forward.lag2eul import (ForwardConfig,
                                                       GrowthParams, lag2eul)

        g = GridSpec.cube(args.N, args.L)
        x = read_grid(args.fname_in, g)
        c = cosmo.preset("wmap7_max", z=args.z)
        gp = GrowthParams(D1=cosmo.d_growth(c), D2=cosmo.d2_growth(c),
                          ascale=c.ascale, cpecvel=cosmo.c_pecvel(c),
                          hubble=cosmo.hubble_a(c))
        mk = args.masskernel
        mk = int(mk) if mk.isdigit() else mk
        fc = ForwardConfig(sfmodel=args.sfmodel, masskernel=mk,
                           slength=args.slength)
        transfer = None
        if args.transf_zeld or args.transf_2lpt:
            # TRANSF build kernels, stored full-layout like the reference's
            # auxtransf* files; keep the rfft half (Lag2Eul.cc:174-191)
            def load_t(fname):
                if not fname:
                    return None
                return read_grid(fname, g)[:, :, : g.rshape[2]]
            transfer = (load_t(args.transf_zeld), load_t(args.transf_2lpt))
        with torch.no_grad():
            d_eul = lag2eul(x, g, fc, gp, transfer=transfer)
        out = args.out or f"{args.fname_in}_eul"
        bio.write_array(out, _host(d_eul))
        print(f"wrote {out}.dat")
        return 0

    if tool == "density":
        from barcode_tpu_torch.forward import assign

        g = GridSpec.cube(args.N, args.L)
        xs = [bio.read_array(f"{args.fname_base}_{a}") for a in "xyz"]
        n_part = xs[0].shape[0]
        h = args.kernel_h if args.kernel_h else g.cell_avg
        pos = torch.from_numpy(np.stack(xs)).to(dev)
        # deposit through the grid-shaped path: pad the particle count to a
        # multiple of the grid's cells with zero-weight particles
        pad = g.N - n_part % g.N if n_part % g.N else 0
        w = torch.cat([torch.ones(n_part, device=dev),
                       torch.zeros(pad, device=dev)])
        posp = torch.nn.functional.pad(pos, (0, pad))
        rho = 0.0
        with torch.no_grad():
            for r in range(posp.shape[1] // g.N):
                sl = slice(r * g.N, (r + 1) * g.N)
                rho = rho + assign.sph_deposit(
                    posp[:, sl].reshape(3, *g.shape), g, h,
                    weights=w[sl].reshape(g.shape))
        out = args.out or f"{args.fname_base}_sph_density"
        bio.write_array(out, _host(rho))
        print(f"wrote {out}.dat")
        return 0

    if tool == "interp_upres":
        from barcode_tpu_torch.forward import assign, particles

        g = GridSpec.cube(args.N, args.L)
        g_out = GridSpec.cube(args.N_out, args.L)
        x = read_grid(args.fname_in, g)
        pos_out = particles.lagrangian_positions(g_out, device=dev)
        up = assign.cic_gather(x, pos_out, g)
        out = args.out or f"{args.fname_in}_interpCIC{args.N_out}"
        bio.write_array(out, _host(up))
        print(f"wrote {out}.dat")
        return 0

    if tool == "poisson_upres":
        # exact reference semantics (discrete_poisson_sample + CIC,
        # tools/poisson_upres.cc:14-157): Poisson counts per INPUT cell with
        # lambda = Nbar*(1+delta), each particle at an independent uniform
        # position inside its input cell, CIC deposit onto the OUTPUT grid,
        # density grid written.  Host numpy, as in the JAX package: the
        # per-particle expansion has a data-dependent size (np.repeat), and
        # the same seed gives the JAX tool's file bit for bit.
        g = GridSpec.cube(args.N, args.L)
        g_out = GridSpec.cube(args.N_out, args.L)
        x = np.asarray(bio.read_array(args.fname_in, g.shape), np.float64)
        lam = np.maximum(args.Nbar * (1.0 + x), 0.0)
        rng = np.random.default_rng(args.seed)
        counts = rng.poisson(lam)
        cells = np.repeat(np.arange(counts.size), counts.ravel())
        ci = cells // (g.N2 * g.N3)
        cj = (cells // g.N3) % g.N2
        ck = cells % g.N3
        d = np.asarray(g.cell, np.float64)
        u = rng.random((3, cells.size))
        pos = np.stack([(ci + u[0]) * d[0], (cj + u[1]) * d[1],
                        (ck + u[2]) * d[2]])
        rho = _cic_deposit_host(pos, g_out)
        out = args.out or f"{args.fname_in}_poisCIC{args.N_out}_Nbar{args.Nbar:g}"
        bio.write_array(out, rho.astype(np.float32))
        print(f"wrote {out}.dat ({cells.size} Poisson particles)")
        return 0

    raise SystemExit(f"unknown tool {args.tool}")


def _cic_deposit_host(pos, g):
    """Host-side CIC deposit of an arbitrary particle list (unit masses),
    the getDensity_CIC convention: base = floor(x/d - 1/2), weights
    (1-frac)/frac over the 8 corners, periodic wrap
    (the reference's barlib/src/massFunctions.cc:100-164)."""
    d = np.asarray(g.cell, np.float64).reshape(3, 1)
    v = pos / d - 0.5
    base = np.floor(v).astype(np.int64)
    frac = v - base
    N = (g.N1, g.N2, g.N3)
    rho = np.zeros(g.shape, np.float64)
    for ox in (0, 1):
        for oy in (0, 1):
            for oz in (0, 1):
                w = ((frac[0] if ox else 1.0 - frac[0])
                     * (frac[1] if oy else 1.0 - frac[1])
                     * (frac[2] if oz else 1.0 - frac[2]))
                np.add.at(rho, ((base[0] + ox) % N[0], (base[1] + oy) % N[1],
                                (base[2] + oz) % N[2]), w)
    return rho


if __name__ == "__main__":
    sys.exit(main())
