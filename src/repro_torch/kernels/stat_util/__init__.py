"""Statistical-utility reduction kernel (Eqn 2, first factor)."""
