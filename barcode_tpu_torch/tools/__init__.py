"""Offline analysis tools — the reference's standalone binaries
(its tools/ directory) as one command line, on the card by default:

    python -m barcode_tpu_torch.tools <tool> [args...] [--device cpu]

Port of barcode_tpu/tools: the same tools (powspec, corr_fct, 2D_powspec,
2D_corr_fct, lag2eul, density, interp_upres, poisson_upres), arguments,
default file names and output formats.  All grid files are raw
reference-format binaries (io.py), file names given without the .dat
extension like the reference tools.
"""
