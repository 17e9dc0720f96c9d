"""The yardstick: manifest lookup, peaks and bounds, trace reduction, and
the comparison that decides `correct`."""
