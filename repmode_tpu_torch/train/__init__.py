"""Train state, train step and the experiment loop of the port."""
