"""``resident_uniform``: each request names a resident column of the lake,
drawn uniformly from the seed."""
import numpy as np


def validate(mix: dict) -> None:
    pass


def columns(mix: dict, seed: int, n_columns: int, n: int) -> np.ndarray:
    """The seed's first ``n`` requested columns."""
    return np.random.default_rng([int(seed), 0x7A]).integers(0, n_columns, size=n)


def request(name: str, column_id: int):
    from repro_torch.service.api import DiscoveryRequest
    return DiscoveryRequest(name=name, column_id=int(column_id))
