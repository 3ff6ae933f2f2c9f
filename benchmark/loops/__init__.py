"""One module per training loop (a traffic mix's ``loop``), found by name:
the loop's set-up epochs, its timed window and what the reference compares
of them."""
