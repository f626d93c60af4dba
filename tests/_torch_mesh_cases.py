"""The four-rank mesh cases of tests/test_torch_mesh_distributed.py: their
inputs, made from seeds with numpy only, so the port's ranks
(tests/_torch_mesh_ranks.py) and the reference's run on four forced host
devices build the same arrays."""
import numpy as np

D = 4                       # ranks / forced host devices
K, M0, LATENT = 8, 9, 3     # tenants, features, latent rank
N = 120                     # samples a tenant
N_SITE = 40                 # samples a federated site
N_DATA = 160                # samples of the data-sharded fit (40 a rank)
KW = dict(layer_sizes=(M0, LATENT, 5, 7, M0), lam_hidden=0.7, lam_last=0.9, seed=1,
          stats_backend="einsum")
STATE_MASK = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
TREE_GROUPS = (2, 8)        # inside a rank (local rounds), over all ranks (2 cross rounds)
METHODS = ("gram", "svd")
DATA_MESHES = {"data": ((D,), ("data",)), "pod_data": ((2, 2), ("pod", "data"))}


def lowrank(n: int, seed: int) -> np.ndarray:
    """tests/_torch_parity.py's ``lowrank_data`` at (M0, LATENT)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(LATENT, n))
    mix = rng.normal(size=(M0, LATENT))
    x = mix @ np.tanh(z) + 0.1 * rng.normal(size=(M0, n))
    x = (x - x.mean(axis=1, keepdims=True)) / x.std(axis=1, keepdims=True)
    return x.astype(np.float32)


def _per_tenant(n: int, seed: int) -> np.ndarray:
    """K tenants' data, each its own mixture, [K, M0, n]."""
    return np.stack([lowrank(n, seed + 100 * t) for t in range(K)])


def tenant_data():
    """K tenants' data [K, M0, N], their seeds and a padding mask."""
    return (_per_tenant(N, 200), np.arange(1, K + 1, dtype=np.int32),
            (np.arange(K) * 13) % N + 1)


def site_data() -> np.ndarray:
    """K federated sites, each its own mixture, [K, M0, N_SITE]."""
    return _per_tenant(N_SITE, 300)


def mesh_data() -> np.ndarray:
    """tests/test_sharded_core.py's data-mesh samples, [M0, N_DATA]."""
    rng = np.random.default_rng(400)
    z = rng.normal(size=(LATENT, N_DATA))
    x = np.tanh(rng.normal(size=(M0, LATENT)) @ z) + 0.05 * rng.normal(size=(M0, N_DATA))
    return ((x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)).astype(np.float32)
