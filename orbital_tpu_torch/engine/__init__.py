"""SoA state, double-single arithmetic, the steppers and rollouts."""
