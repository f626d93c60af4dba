"""RPR003 fixture (the port's): host syncs on tensors inside a capture."""
import numpy as np
import torch


def bad_item_and_friends(g, x, out):
    with torch.cuda.graph(g):
        y = x * 2
        out.fill_(y.sum().item())                            # line 9: RPR003
        rows = y.cpu()                                       # line 10: RPR003
        host = y.numpy() + y.tolist()[0]                     # line 11: RPR003 x2
    return rows, host


def bad_scalar_of_a_tensor(g, x):
    with torch.cuda.graph(g):
        total = torch.zeros(1, device=x.device)
        scale = float(total)                                 # line 18: RPR003
        x.mul_(scale)


def bad_host_numpy(g, x):
    with torch.cuda.graph(g):
        return np.asarray(x) + 1.0                           # line 24: RPR003


def clean_static(g, x):
    with torch.cuda.graph(g):
        n = float(x.shape[0]) + int(len(x))   # static metadata, allowed
        x.div_(n * np.pi)                     # no tensor enters np
    return x.sum().item()                     # after the capture: fine
