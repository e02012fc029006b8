"""The yardstick's arithmetic: model FLOPs, the divided attention's
operations and bytes, and the card's published peaks. Copies, so that a
change to the program cannot move them."""
