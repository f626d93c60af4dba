# repro-lint: privacy
"""RPR007 fixture (the port's): literal seeds in privacy code."""
import torch


def bad_global_seed():
    torch.manual_seed(0)                                     # line 7: RPR007


def bad_generator_seed(device):
    gen = torch.Generator(device=device)
    gen.manual_seed(42)                                      # line 12: RPR007
    return torch.Generator().manual_seed(7), gen             # line 13: RPR007


def bad_cuda_seed():
    torch.cuda.manual_seed(3)                                # line 17: RPR007


def ok_derived_seed(seed, site):
    torch.manual_seed(seed * 1_000_003 + site)


def ok_disable_escape():
    torch.manual_seed(11)  # repro-lint: disable=RPR007
