"""Data pipelines of the port."""
from .synthetic import (SyntheticLM, dirichlet_partition, logistic_problem,
                        quadratic_problem)

__all__ = ["SyntheticLM", "dirichlet_partition", "quadratic_problem",
           "logistic_problem"]
