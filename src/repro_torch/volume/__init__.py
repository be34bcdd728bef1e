"""Storage-side pieces the serving path uses: the read tier."""
