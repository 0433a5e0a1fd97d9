"""Plain references the benchmark judges the program by. They use torch
and numpy alone and nothing of the program: each works out again, from
the same inputs, what the program derived."""
