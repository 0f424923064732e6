"""One driver a traffic mix: set-up, window and check of a cell."""
