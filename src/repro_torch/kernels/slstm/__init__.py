"""The sLSTM recurrence kernel (xLSTM prefill)."""
