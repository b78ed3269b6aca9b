"""SoA state, double-single arithmetic, the KDK stepper and rollouts."""
