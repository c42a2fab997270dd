// Realtime page: poll /realtime_result, switch models without a reload,
// stop the camera (reference templates/realtime.html:584-712 interaction set).
(() => {
  const esc = (s) => String(s).replace(/[&<>"]/g,
    (c) => ({'&': '&amp;', '<': '&lt;', '>': '&gt;', '"': '&quot;'}[c]));

  const ident = document.getElementById('rident');
  const conf = document.getElementById('rconf');
  const fps = document.getElementById('rfps');
  const status = document.getElementById('rstatus');
  const faces = document.getElementById('rfaces');

  let lastT = 0;
  const poll = async () => {
    let r;
    try {
      r = await (await fetch('/realtime_result')).json();
    } catch (e) {
      status.textContent = 'disconnected';
      status.className = 'badge down';
      return;
    }
    status.textContent = 'live';
    status.className = 'badge live';
    ident.textContent = r.identity ?? '…';
    ident.className = (r.identity && r.identity !== 'Unknown' &&
                       r.identity !== 'No face') ? 'id' : 'id unknown';
    conf.textContent = r.confidence ? ' ' + (+r.confidence).toFixed(3) : '';
    const now = performance.now();
    if (r.time_ms) {
      fps.textContent = `${(+r.time_ms).toFixed(1)} ms/frame`;
    } else if (lastT) {
      fps.textContent = `poll ${(now - lastT).toFixed(0)} ms`;
    }
    lastT = now;
    const list = r.faces || [];
    faces.style.display = list.length > 1 ? 'table' : 'none';
    faces.innerHTML = '<tr><th>face</th><th>confidence</th></tr>' + list.map(
      (f) => `<tr><td>${esc(f.identity)}</td>` +
             `<td>${(+f.confidence).toFixed(3)}</td></tr>`).join('');
  };
  setInterval(poll, 500);

  document.getElementById('setmodel').addEventListener('click', async () => {
    const model = document.getElementById('rmodel').value;
    const ms = document.getElementById('modelstatus');
    ms.textContent = '…';
    const r = await fetch('/set_realtime_model', {
      method: 'POST',
      body: new URLSearchParams({model}),
    });
    const j = await r.json();
    ms.textContent = j.error ? j.error : `using ${j.model}`;
  });

  document.getElementById('stopcam').addEventListener('click', async () => {
    await fetch('/stop_camera', {method: 'POST'});
    status.textContent = 'stopped';
    status.className = 'badge down';
  });
})();
