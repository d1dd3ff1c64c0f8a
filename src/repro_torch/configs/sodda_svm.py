"""The paper's own experiment configuration: doubly-distributed hinge-loss SVM.

The port's own copy of the reference's ``SoddaConfig`` (same fields, same
defaults; ``tests/test_torch_isolation.py`` holds the two equal), so the
port needs nothing of the JAX package at run time.

Synthetic datasets per Fang & Klabjan Table 1 (P=5 observation partitions,
Q=3 feature partitions; partition sizes 50k x 6k / 60k x 7k / 60k x 9k),
learning rate gamma_t = 1/(1+sqrt(t-1)), knobs (b,c,d) = (85%, 80%, 85%),
inner batch L and hinge loss.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SoddaConfig:
    name: str = "sodda-svm"
    loss: str = "hinge"  # hinge | logistic | squared
    P: int = 5  # observation partitions
    Q: int = 3  # feature partitions
    n: int = 50_000  # observations per partition
    m: int = 6_000  # features per partition
    L: int = 64  # inner loop length
    b_frac: float = 0.85  # feature sample fraction (B^t)
    c_frac: float = 0.80  # gradient-coordinate fraction (C^t subset of B^t)
    d_frac: float = 0.85  # observation sample fraction (D^t)
    lr0: float = 1.0  # gamma_t = lr0 / (1 + sqrt(t-1))
    constant_lr: float = 0.0  # >0: use constant gamma (Theorems 3/4 regime)
    l2: float = 0.0  # optional ridge term
    seed: int = 0

    @property
    def N(self) -> int:
        return self.P * self.n

    @property
    def M(self) -> int:
        return self.Q * self.m

    @property
    def m_tilde(self) -> int:
        return self.M // (self.Q * self.P)

    def gamma(self, t):
        """Paper's schedule gamma_t = lr0/(1+sqrt(t-1)) (t is 1-based)."""
        if self.constant_lr > 0:
            return self.constant_lr
        return self.lr0 / (1.0 + (max(t, 1) - 1) ** 0.5)


# Paper Table 1 instances.
SMALL = SoddaConfig(n=50_000, m=6_000)
MEDIUM = SoddaConfig(name="sodda-svm-medium", n=60_000, m=7_000)
LARGE = SoddaConfig(name="sodda-svm-large", n=60_000, m=9_000)

# The paper's Table-1 250k x 18k instance as the reference's large benchmark
# cell runs it: N = 250 000, M = 18 000, m_tilde = 1 200, with lr0 = 0.01
# (lr0 = 1.0 overshoots at this width; the hinge objective climbs first).
TABLE1_250K_18K = SoddaConfig(name="sodda-table1-250kx18k", P=5, Q=3,
                              n=50_000, m=6_000, L=64, lr0=0.01)

CONFIG = SMALL
