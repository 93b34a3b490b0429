"""The plain reference: what the program's outputs are judged against."""
