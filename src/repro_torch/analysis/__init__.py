"""The port's side of pmemlint: the markers its passes key on."""
