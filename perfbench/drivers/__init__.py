"""Drivers: how a configuration's cells are set up, timed and checked
(`perfbench/configs/<config>.json` names its driver)."""
