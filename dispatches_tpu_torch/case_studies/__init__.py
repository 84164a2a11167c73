"""Case studies of the port: renewables (wind, battery, PEM, hydrogen;
the price-takers and the double loop), nuclear, and the fossil USC
plant."""
