"""The program's C(amp)·RBF(ℓ) + White(noise) kernel object, with the
configuration's bounds."""
import torch

from port_bench import program


def make(cfg: dict, device):
    K = program.module("kernels")
    k = cfg["kernel"]
    b = k.get("bounds", {})
    bound = lambda name: {"bounds": tuple(b[name])} if name in b else {}
    ls = torch.tensor(k["lengthscale"], dtype=getattr(torch, cfg["dtype"]), device=device)
    return (K.Constant(k["amplitude"], **bound("amplitude")) * K.RBF(ls, **bound("lengthscale"))
            + K.White(k["noise"], **bound("noise")))
