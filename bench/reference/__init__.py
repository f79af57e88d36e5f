"""The plain reference TIMEST estimator: torch and numpy only, nothing of
the program under test."""
