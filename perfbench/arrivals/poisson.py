"""``poisson``: one generator thread sends at exponential gaps of mean
1/``rate_qps``, each request timed from its due time."""
import numpy as np

from perfbench import traffic


def validate(mix: dict) -> None:
    if float(mix.get("rate_qps", 0)) <= 0:
        raise ValueError("traffic: a poisson mix needs rate_qps > 0")


def schedule(mix: dict, seed: int, seconds: float) -> np.ndarray:
    """Due offsets (s) of the arrivals that fall in ``[0, seconds)``."""
    rate = float(mix["rate_qps"])
    rng = np.random.default_rng([int(seed), 0xA2])
    n = int(rate * seconds * 1.2) + 64
    t = np.cumsum(rng.exponential(1.0 / rate, size=n))
    while t[-1] < seconds:
        t = np.concatenate([t, t[-1] + np.cumsum(rng.exponential(1.0 / rate, size=n))])
    return t[t < seconds]


def drive(mix: dict, client: "traffic.Client") -> "traffic.Window":
    return traffic.open_loop(schedule(mix, client.seed, client.seconds), client)
