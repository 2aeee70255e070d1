"""kernel.extract_bank_roofline (%): the least time of the jobs'
extraction with the bank plane (benchmark/roofline.py: 2 bits a base in,
W + 1 32-bit words a valid window out, the k-mer's W and its bank id,
over the card's memory bandwidth) over the summed device time of the
fused wire kernel (csrc/extract.cu, its BANK instance) in the traced
window.  kernel.extract_roofline counts W words a window and would
under-read this instance."""

from benchmark import roofline


def read(ctx):
    tr, peak = ctx["trace"], roofline.peaks(ctx["device_kind"])
    if tr is None or peak is None:
        return None
    dev = tr.device_s("kernels.extract")
    if dev <= 0:
        return None
    need = sum(roofline.extract_bytes(j["bases"], j["windows"], ctx["W"] + 1)
               for j in ctx["jobs"])
    return 100.0 * need / peak["hbm_bytes_per_s"] / dev
