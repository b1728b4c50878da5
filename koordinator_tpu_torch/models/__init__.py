"""The scheduling round: inputs, plain round, kernel selector."""
