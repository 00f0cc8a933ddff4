"""REWAFL core: utility, policy, selection, fleet state and the sync round."""
