"""The benchmark's plain reference (`frt/`, a frozen copy of the port's
plain torch path) and the comparison that decides `correct`
(`compare.py`). Nothing here imports the port."""
