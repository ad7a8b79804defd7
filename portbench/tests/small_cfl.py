"""The CPU size of configuration cfl-50x50, 4 facilities × 6 customers (the
pool's four instances stay, each a MIP of 16 settings of its binaries):
importing this file registers it with ``small.SIZES``."""

import small

SIZE = {"facilities": 4, "customers": 6}
small.SIZES.setdefault("cfl-50x50", SIZE)
